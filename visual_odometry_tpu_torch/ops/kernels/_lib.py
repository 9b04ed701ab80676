"""Build, load and launch the CUDA kernels of ``csrc/``.

The kernel sources are compiled on the machine with the card, at the
first launch: one ``nvcc -c`` per source, all started together, then one
``nvcc -shared`` link into ``build/vo_torch_kernels/`` under the repository
root, named by a hash of the sources and flags. A build writes into a fresh
temporary directory and ``os.replace``-s the finished library into place, so
concurrent processes never load a half-written file. The library has a plain
C interface and is loaded with ``ctypes``; every entry point launches on
PyTorch's current stream and returns ``cudaGetLastError()``. A launch takes
no lock once the library is loaded and enters no device context when its
tensors are on the current device.

Nothing here runs at import: a CPU host imports this module, never builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ...utils import roofline
from ...utils.config import BACKENDS

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vo_torch_kernels"
SOURCES = ("match_pairs.cu", "join_candidates.cu", "gather_rows.cu", "track_frames.cu",
           "picp_solve.cu", "best_match.cu", "picp_linearize.cu", "take_table.cu",
           "segment_sum.cu", "eight_point.cu", "map_fold.cu")
HEADERS = ("common.cuh", "gn_loop.cuh")
# --fmad=false: no multiply-add contraction, so kernel arithmetic rounds like
# the plain versions' separate PyTorch ops (see csrc/common.cuh).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

# Launches per kernel, counted by the wrappers right after a successful
# launch and nowhere else; chip_smoke.py resets and reads them.
launches = {
    "match_pairs": 0, "join_candidates": 0, "gather_rows": 0, "track_frames": 0,
    "track_frames_planar": 0, "picp_solve": 0, "picp_solve_se2": 0,
    "best_match": 0, "best_match_fast": 0,
    "track_frames_batched": 0, "track_frames_batched_planar": 0,
    "segment_sum": 0, "take_table": 0, "picp_linearize": 0, "eight_point": 0, "map_fold": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# Work per kernel function, whichever backend computes it, counted only
# inside :func:`counting_work` (None outside it, where a dispatch pays one
# test): each dispatcher adds its ``utils/roofline`` model at the call's
# shapes (GN rounds at the budget, so the count depends on shapes alone):
# {name: [calls, tensor-core FLOPs, FP32 operations, bytes, least seconds on
# roofline.H100]}. parallel/scaling reads it a rank.
work: Optional[dict] = None


@functools.lru_cache(maxsize=4096)
def _counts(model_fn, args: tuple) -> tuple:
    """A model's counts and least time on roofline.H100, reckoned once a shape."""
    m = model_fn(*args)
    return m.tc_flops, m.fp32_ops, m.hbm_bytes, m.speed_of_light_s(roofline.H100)


def tally(name: str, model_fn, *args) -> None:
    """Add ``model_fn(*args)``, a ``utils/roofline`` model, to ``work[name]``
    while :func:`counting_work` is active."""
    if work is None:
        return
    counts = _counts(model_fn, args)
    row = work.get(name)
    if row is None:
        row = work[name] = [0, 0.0, 0.0, 0.0, 0.0]
    row[0] += 1
    for i, c in enumerate(counts, 1):
        row[i] += c


@contextlib.contextmanager
def counting_work():
    """Tally the work of every dispatch inside the block into a fresh dict,
    which it yields."""
    global work
    outer, work = work, {}
    try:
        yield work
    finally:
        work = outer


def use_kernel(backend: str, tensor: torch.Tensor) -> bool:
    """Resolve a backend knob for an input tensor (utils/config.py)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; expected one of {BACKENDS}")
    if backend == "torch":
        return False
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; got a tensor on " + str(tensor.device))
    return tensor.is_cuda


def cuda_device(t: torch.Tensor) -> torch.device:
    """The CUDA device a kernel launch runs on; raises for any other tensor."""
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors; got one on {t.device}")
    return t.device


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: one test on the launch path, the message built only for a
    tensor that fails it."""
    if (t.dtype is not dtype or t.shape != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype is not dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.shape != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        raise ValueError(f"{name} must be contiguous")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvo_torch_kernels-{_digest()}.so"


def build() -> tuple:
    """Compile the library if it is not built yet; returns (path, seconds, log)."""
    target = library_path()
    log_path = target.with_suffix(".log")
    if target.exists():
        return target, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs))
        lib_tmp = tmp / "lib.so"
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(lib_tmp)]
        link += [str(obj) for _, obj, _ in procs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        log = "\n".join(logs) + res.stdout
        (tmp / "build.log").write_text(log)
        os.replace(tmp / "build.log", log_path)
        os.replace(lib_tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target, time.perf_counter() - t0, log


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


class Mount(ctypes.Structure):
    """P1's planar mount by value (csrc/eight_point.cu): 16 floats row-major
    and a flag, 0 for no planar projection."""

    _fields_ = [("m", ctypes.c_float * 16), ("planar", ctypes.c_int)]


_SIGNATURES = {
    "vo_match_pairs": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vo_join_candidates": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vo_gather_rows": [_P] * 3 + [_I] * 4 + [_L, _L, _P],
    "vo_track_frames": [_P] * 13 + [_I] * 5 + [_P],
    "vo_track_frames_planar": [_P] * 13 + [_I] * 5 + [_P],
    "vo_picp_solve": [_P] * 10 + [_I] * 5 + [_F] * 5 + [_P],
    "vo_picp_solve_se2": [_P] * 11 + [_I] * 5 + [_F] * 5 + [_P],
    "vo_best_match": [_P] * 9 + [_I] * 5 + [_P],
    "vo_track_frames_batched": [_P] * 14 + [_I] * 6 + [_P],
    "vo_track_frames_batched_planar": [_P] * 14 + [_I] * 6 + [_P],
    "vo_segment_sum": [_P, _P, _P, _P, _I, _I, _P],
    "vo_take_table": [_P, _L, _L, _P, _P, _L, _I, _I, _I, _P],
    "vo_picp_linearize": [_P] * 12 + [_I] * 3 + [_F, _F, _P],
    "vo_eight_point": [_P] * 9 + [_I] * 3 + [_P],
    "vo_eight_point_seed": [_P] * 18 + [_I] * 5 + [_L] * 5 + [Mount, _P],
    "vo_map_fold": [_P] * 11 + [_I] * 6 + [_P],
}

_lib = None
_lib_lock = threading.Lock()
# The entry points by symbol, and the current-device and current-stream
# getters, set once with the library; a launch reads them without the lock.
_entries: dict = {}
_current_device = _raw_stream = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _current_device, _raw_stream
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[name] = fn
            lib.vo_error_string.argtypes = [ctypes.c_int]
            lib.vo_error_string.restype = ctypes.c_char_p
            # The current device's index, and the cudaStream_t of a device's
            # current stream as an int without building a torch.cuda.Stream.
            _current_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
            _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
                lambda index: torch.cuda.current_stream(index).cuda_stream)
            _lib = lib
    return _lib


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call a kernel entry point on ``device``'s current stream; raise on a
    refused launch, count a successful one. The device context is entered
    only when ``device`` is not the current device."""
    if _lib is None:
        library()
    fn = _entries[symbol]
    index = device.index
    if index == _current_device():
        code = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(device):
            code = fn(*args, _raw_stream(_current_device()))
    if code != 0:
        msg = _lib.vo_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {code} ({msg})")
    launches[kernel] += 1


# Per (device, stream) scratch of the kernels that fold across CTAs with a
# ticket counter (K11): int32 words, zeroed once when made; such a kernel
# finds its counter (word 0) zero and leaves it zero, and launches on one
# stream never overlap, so they may share the rest.
_scratch: dict = {}


def stream_scratch(device: torch.device, words: int) -> torch.Tensor:
    """A zeroed-at-creation int32 buffer of at least ``words`` entries owned by
    ``device``'s current stream."""
    if _lib is None:
        library()
    index = _current_device() if device.index is None else device.index
    key = (index, _raw_stream(index))
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int32, device=torch.device("cuda", index))
        _scratch[key] = buf
    return buf
