"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``videocad_tpu_torch/csrc/`` with a
plain C entry point. It is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/kernels/`` at the repository root, at
first use, and loaded with ``ctypes``. The library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded. Only sources under ``csrc/`` are compiled.

Nothing here runs at import time: the CPU tests import every module of the
package, and a machine without ``nvcc`` never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling, compiler output); empty when the
# library was already on disk.
build_log: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
            "built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no kernel source {src}")
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Compile to a temporary name and rename: a concurrent or cut
            # build never leaves a half-written library under the final
            # name.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            start = time.monotonic()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = (time.monotonic() - start,
                               proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
