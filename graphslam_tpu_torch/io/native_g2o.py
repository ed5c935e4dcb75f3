"""ctypes bridge to the native C++ g2o parser (native/g2o_parser.cc); port of
graphslam_tpu/io/native_g2o.py.

`_lib()` builds the parser at first use with the flags of native/Makefile
into the package's `build/` directory (listed in .gitignore), and rebuilds it
only when the source is newer than the library. It compiles to a temporary
file and moves it into place with os.replace, so processes that build at
once (test workers) each load a whole library. `parse` never falls back: it
raises when the library cannot be built or loaded, so a caller that asks for
the native parser gets it. `io.g2o.load_g2o(use_native=True)` is the caller
that falls back to the Python parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "g2o_parser.cc"
LIBRARY = _PKG / "build" / "libg2o_parser.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_LIB = None


def build(library: Optional[Path] = None) -> Path:
    """Compile SOURCE into `library` (default LIBRARY) unless the library is
    at least as new as the source. Raises RuntimeError with the compiler's
    output when the build fails."""
    library = Path(library or LIBRARY)
    if library.exists() and library.stat().st_mtime >= SOURCE.stat().st_mtime:
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=library.name + ".", suffix=".tmp", dir=library.parent)
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
        if out.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({out.returncode}):\n{out.stderr}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return library


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.g2o_parse.restype = ctypes.c_void_p
        lib.g2o_parse.argtypes = [ctypes.c_char_p]
        lib.g2o_free.argtypes = [ctypes.c_void_p]
        lib.g2o_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for fn in (lib.g2o_copy_se2, lib.g2o_copy_se3):
            fn.argtypes = [ctypes.c_void_p, iptr, dptr, iptr, dptr, dptr]
        _LIB = lib
    return _LIB


def parse(path: str) -> Dict[str, np.ndarray]:
    """Parse a g2o file natively; returns the same intermediate dict as
    g2o._python_parse (see io/g2o.py)."""
    lib = _lib()
    h = lib.g2o_parse(os.fsencode(path))
    if not h:
        raise IOError(f"native parser failed to open {path}")
    try:
        sizes = (ctypes.c_int64 * 4)()
        lib.g2o_sizes(h, sizes)
        n_v2, n_e2, n_v3, n_e3 = (int(s) for s in sizes)
        if n_v2 > 0:
            ids = np.empty(n_v2, np.int64)
            poses = np.empty((n_v2, 3), np.float64)
            edges = np.empty((n_e2, 2), np.int64)
            meas = np.empty((n_e2, 3), np.float64)
            info = np.empty((n_e2, 6), np.float64)
            lib.g2o_copy_se2(h, ids, poses, edges, meas, info)
            return {
                "dim": 2,
                "ids": ids,
                "poses_raw": poses,
                "edges": edges,
                "meas_raw": meas,
                "info_raw": info,
            }
        if n_v3 > 0:
            ids = np.empty(n_v3, np.int64)
            poses = np.empty((n_v3, 7), np.float64)
            edges = np.empty((n_e3, 2), np.int64)
            meas = np.empty((n_e3, 7), np.float64)
            info = np.empty((n_e3, 21), np.float64)
            lib.g2o_copy_se3(h, ids, poses, edges, meas, info)
            return {
                "dim": 3,
                "ids": ids,
                "poses_t": poses[:, :3],
                "poses_q": poses[:, 3:7],
                "edges": edges,
                "meas_t": meas[:, :3],
                "meas_q": meas[:, 3:7],
                "info_raw": info,
            }
        raise ValueError(f"no vertices found in {path}")
    finally:
        lib.g2o_free(h)
