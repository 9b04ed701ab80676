"""ctypes binding of the native dataset parser (``vo_io.cpp``).

The library is compiled with ``g++`` at first use into ``build/vo_torch_native/``
under the repository root, named by a hash of the source, the compiler and
its flags; a build writes into a fresh temporary directory and
``os.replace``-s the finished library into place. Nothing is built at import.

A failed build raises :class:`NativeBuildFailure` carrying the compiler's
output, and is remembered for the process: the next call raises it again
without recompiling. ``utils/io.load_sequence(parser="auto")`` turns that
into one warning and parses with numpy; ``parser="native"`` lets it raise.
Both parsers give identical arrays (tests/test_torch_native_io.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "vo_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vo_torch_native"
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: dict = {}   # compiler -> the loaded library, or the NativeBuildFailure of its build


class NativeBuildFailure(RuntimeError):
    """The native parser could not be compiled or loaded."""


def library_path(compiler: str) -> Path:
    """Where ``compiler``'s build of the parser lives."""
    h = hashlib.sha256(" ".join((compiler,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvo_io-{h.hexdigest()[:16]}.so"


def build(compiler: str) -> Path:
    """Compile the library with ``compiler`` unless it is built already;
    returns its path."""
    target = library_path(compiler)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        out = tmp / "lib.so"
        try:
            res = subprocess.run([compiler, *FLAGS, str(SOURCE), "-o", str(out)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildFailure(f"{compiler} could not build {SOURCE.name}: {e}") from e
        if res.returncode != 0:
            raise NativeBuildFailure(f"{compiler} failed to build {SOURCE.name} "
                                   f"(exit {res.returncode}):\n{res.stdout}")
        os.replace(out, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded parser, built with :data:`COMPILER` at the first call;
    raises NativeBuildFailure."""
    compiler = COMPILER
    with _lock:
        if compiler not in _loaded:
            try:
                _loaded[compiler] = _bind(ctypes.CDLL(str(build(compiler))))
            except NativeBuildFailure as e:
                _loaded[compiler] = e
            except OSError as e:
                _loaded[compiler] = NativeBuildFailure(f"cannot load the native parser: {e}")
        lib = _loaded[compiler]
    if isinstance(lib, NativeBuildFailure):
        raise lib
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vo_parse_table.restype = ctypes.c_long
    lib.vo_parse_table.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.vo_free.restype = None
    lib.vo_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.vo_load_sequence.restype = ctypes.c_long
    lib.vo_load_sequence.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vo_free_buf.restype = None
    lib.vo_free_buf.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the parser builds and loads (building it if need be)."""
    try:
        library()
    except NativeBuildFailure:
        return False
    return True


def parse_table(path: str, skiprows: int, first_col: int, n_cols: int) -> Optional[np.ndarray]:
    """A whitespace table as a (rows, n_cols) float64 array: the first
    ``skiprows`` lines skipped, ``first_col`` leading tokens of each line
    dropped, blank and short lines ignored. None when the file cannot be read."""
    lib = library()
    out = ctypes.POINTER(ctypes.c_double)()
    rows = lib.vo_parse_table(os.fsencode(path), skiprows, first_col, n_cols, ctypes.byref(out))
    if rows < 0:
        return None
    try:
        if rows == 0:
            return np.zeros((0, n_cols), np.float64)
        return np.ctypeslib.as_array(out, shape=(rows, n_cols)).copy()
    finally:
        if out:
            lib.vo_free(out)


def load_sequence_native(data_dir: str, n_slots: Optional[int], pad_appearance: float):
    """Every ``meas-*.dat`` of ``data_dir`` parsed by a pool of C++ threads and
    padded as ``utils.io.pad_frames`` pads: (points (F, S, 2) f32, appearances
    (F, S, 10) f32, ids (F, S) i32, mask (F, S) bool, counts (F,) i32). None
    when a file cannot be read, there is none, or a frame exceeds ``n_slots``."""
    lib = library()
    pts_p = ctypes.POINTER(ctypes.c_float)()
    apps_p = ctypes.POINTER(ctypes.c_float)()
    ids_p = ctypes.POINTER(ctypes.c_int)()
    mask_p = ctypes.POINTER(ctypes.c_ubyte)()
    counts_p = ctypes.POINTER(ctypes.c_int)()
    s_out = ctypes.c_int(0)
    f = lib.vo_load_sequence(
        os.fsencode(data_dir), 0 if n_slots is None else int(n_slots),
        ctypes.c_float(pad_appearance), ctypes.byref(pts_p), ctypes.byref(apps_p),
        ctypes.byref(ids_p), ctypes.byref(mask_p), ctypes.byref(counts_p), ctypes.byref(s_out),
    )
    if f <= 0:
        return None
    s = s_out.value
    try:
        return (np.ctypeslib.as_array(pts_p, shape=(f, s, 2)).copy(),
                np.ctypeslib.as_array(apps_p, shape=(f, s, 10)).copy(),
                np.ctypeslib.as_array(ids_p, shape=(f, s)).copy(),
                np.ctypeslib.as_array(mask_p, shape=(f, s)).astype(bool),
                np.ctypeslib.as_array(counts_p, shape=(f,)).copy())
    finally:
        for p in (pts_p, apps_p, ids_p, mask_p, counts_p):
            lib.vo_free_buf(p)
