"""The plain references the benchmark holds the program's outputs to, one
module a configuration names under ``reference``: ``vo`` (``track``) for the
single-sequence and batched paths, ``vo_chunked`` (``track`` and its own
``gaps``) for the sequence-parallel path, ``vo_reloc`` (``track`` and its own
``gaps``) for map-scale relocalization. Plain PyTorch, no kernels; they
import nothing of the program and take nothing the program made: they read
the pool the benchmark made and work out every stage again."""
