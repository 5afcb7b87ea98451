"""Build and load the port's hand-written CUDA kernels.

Each source is one ``.cu`` file under ``videocad_tpu_torch/csrc/`` with
plain C entry points (a source may hold several kernels that share code:
``mhsa_short.cu`` the forward and the backward), and may include the
headers beside it (``tc_common.cuh``: the tensor-core building blocks of
``mhsa_short.cu``, ``flash_attention.cu`` and ``fused_block.cu``). It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, at first use, and loaded with
``ctypes``. The library's file name carries a hash of its source and of
the headers, so an edited source or header is rebuilt and a stale library
is never loaded. Only sources under ``csrc/`` are compiled.
:func:`build_all` compiles every source at once, one ``nvcc`` process
each, all started together.

Nothing here runs at import time: the CPU tests import every module of the
package, and a machine without ``nvcc`` never builds anything.

:func:`launch` is the wrappers' way into a C entry: the current stream's
raw handle, and a device guard only where the tensor is not on the current
device.
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
from typing import Dict, List, Tuple

import torch

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
    """Where the library built from ``csrc/<name>.cu`` lives. Its name
    carries a hash of the source and of every header under ``csrc/`` (a
    source may include any of them), so an edited header rebuilds too."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def sources() -> List[str]:
    """The names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library is on disk.

    Returns None, or (process, temporary path, final path, start time). It
    compiles to a temporary name that :func:`_finish_build` renames: a
    concurrent or cut build never leaves a half-written library under the
    final name.
    """
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.monotonic()


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, start = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    build_log[name] = (time.monotonic() - start, log)


def build_all() -> List[str]:
    """Build every source under ``csrc/`` whose library is missing, all
    ``nvcc`` processes started together; returns the sources' names."""
    names = sources()
    with _lock:
        started = [(name, _start_build(name)) for name in names]
        errors = []
        for name, build in started:
            try:
                _finish_build(name, build)
            except RuntimeError as exc:   # let the other processes end first
                errors.append(exc)
        if errors:
            raise errors[0]
    return names


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock:
        if name not in _loaded:
            _finish_build(name, _start_build(name))
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def launch(entry, device_index: int, *args) -> int:
    """Call ``entry(*args, stream)``, a kernel's C entry, with the raw
    handle of the current stream of CUDA device ``device_index``; returns
    the entry's status. The kernels launch on the current device, so a
    device guard is entered only when ``device_index`` is not it: entering
    one costs the host two device exchanges a call."""
    if device_index == torch._C._cuda_getDevice():
        return entry(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(device_index))


def on_device(fn, device_index: int, *args):
    """``fn(*args)``, a C entry that asks the runtime about the current
    device, with CUDA device ``device_index`` current: a guard is entered
    only when it is not."""
    if device_index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(device_index):
        return fn(*args)
