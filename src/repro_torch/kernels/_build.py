"""Build and load the port's CUDA kernels (``nvcc`` → ``.so`` → ``ctypes``).

Each source under ``csrc/`` has a plain C launcher, so it compiles with
``nvcc -shared`` in seconds without PyTorch's headers.  The library lands
in ``_build/`` next to this file, keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, and is built at first
use; a changed source or header builds anew.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries and their build records, by source name; the lock
# keeps threads that launch at once (the serve engine's) from building
# one source twice
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}
_LOCK = threading.RLock()


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the standard toolkit path or ``PATH``."""
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """The source of ``name`` and its library's path, keyed by the source,
    every header beside it (``csrc/*.cuh``, which a source may include)
    and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one ``nvcc`` for ``name`` unless its library exists; returns
    ``(so_path, popen or None, tmp_path, t0)``."""
    src, so = _target(name)
    if so.exists():
        return so, None, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return so, proc, tmp, time.perf_counter()


def _finish(name: str, so, proc, tmp, t0) -> None:
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, so)   # atomic: concurrent builders agree
        BUILD_LOG[name] = dict(seconds=time.perf_counter() - t0,
                               ptxas=out.strip(), built=True)
    else:
        BUILD_LOG.setdefault(name, dict(seconds=0.0, ptxas="", built=False))
    _LIBS[name] = ctypes.CDLL(str(so))


def build_all(names: list[str]) -> dict[str, dict]:
    """Build every named source at once (one ``nvcc`` each, all started
    together) and load them; returns the build records."""
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        for n, job in started.items():
            _finish(n, *job)
        return {n: BUILD_LOG[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib
