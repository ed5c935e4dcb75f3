"""Build the CUDA sources in csrc/ with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so one
nvcc call builds it in seconds, and several sources build in parallel. The
library lands in the package's `build/` directory (listed in .gitignore)
under a name that carries a hash of the flags, the source and the csrc/
headers it includes, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. A failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """csrc/<name>.cu and every csrc/ file it includes with #include "...",
    recursively, in the order first reached."""
    seen: List[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Tuple[Path, Path, Path]:
    """(source, library, compiler log) of csrc/<name>.cu under a hash of the
    flags, the source and the headers it includes, so an edited header
    rebuilds every library that includes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    lib = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    return SRC_DIR / f"{name}.cu", lib, lib.with_suffix(".log")


def build_all(names: Sequence[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile each csrc/<name>.cu for sm_90a unless an up-to-date build
    exists, one nvcc process per source, all started at once. Returns
    {name: (library path, compiler log: ptxas register/spill report)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, log = _target(name)
        if not (lib.exists() and log.exists()):
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        src, lib, log = _target(name)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src} (exit {proc.returncode}):\n{out}\n{err}")
            continue
        log.write_text(out + err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: (_target(name)[1], _target(name)[2].read_text()) for name in names}


def build(name: str) -> Tuple[Path, str]:
    """build_all for one source: (library path, compiler log)."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
