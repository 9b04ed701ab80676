"""vobench: the benchmark of visual_odometry_tpu_torch, the PyTorch/CUDA port.

One run is one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix), run once in its own process:

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json``, which
names its entry driver ``entries/<entry>.py``, the limits of the output check
``limits/<workload>.json`` and each metric's reader ``metrics/<metric>.py``
(for a name with a dot and no file of its own, such as ``call_p95_ms.single``,
the reader of the name before its last dot). A configuration names its plain
reference (``reference/<name>.py``: ``track``, and where it has one its own
``gaps``, every number of which the limits file has to bound) and, where its
deployment needs more than tracking sequences, its traffic generator
(``generators/<name>.py``: ``make_pool`` and ``occupancy``; else
``generator.py``).
A new cell is new files and new entries in ``BENCHMARK.json``; no file here
needs an edit for it.

The yardstick lives here and nowhere in the program: the traffic generators
(``generator``, ``generators``), the plain references the outputs are held to
(``reference``), the comparison (``compare``), the card's peaks (``peaks``),
the kernels' work models (``workmodels``) and the reading of the profiler's
trace (``tracing``). This package imports nothing of the JAX package, and a run
whose process holds JAX or the JAX package once its reference and readers
have run prints no result.
"""
