"""ctypes bindings for the repository's C++ batch loader (``native/loader.cpp``).

Port of ``videocad_tpu/data/native.py``. A C++ thread pool streams packed
``.vcb`` sequence files and assembles padded uint8 batches straight into
numpy buffers: no pickle, no per-frame Python loop, no PIL.
:class:`NativePipeline` yields the dicts ``DataPipeline.epoch()`` yields,
so the trainer and ``device_prefetch`` take either.

:func:`build_library` compiles ``native/loader.cpp`` with ``g++`` at first
use into ``build/native/`` at the repository root (git-ignored), under a
name that carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library never loaded. It never writes into
``native/``: the library there is the JAX package's, and tracked. Each
process compiles into a temporary file of its own and renames it into
place, so processes that race on the first build never load a half-written
file. A failed compile raises with the compiler's output; nothing falls
back to the Python pipeline.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from videocad_tpu_torch.data.collate import check_rows
from videocad_tpu_torch.etl.dataset_gen import shard_path

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "loader.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def build_library(force: bool = False) -> str:
    """Compile ``native/loader.cpp`` (once per source hash); returns the
    library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_DIR / f"libvcb_loader-{digest.hexdigest()[:16]}.so"
    if lib.exists() and not force:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"native loader: no C++ compiler ({err})") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native loader compile failed ({' '.join(cmd)}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


def load_library():
    """Build (at first use) and load the library, with its C signatures
    bound."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_library())
        lib.vcb_loader_create.restype = ctypes.c_void_p
        lib.vcb_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.vcb_loader_num_batches.restype = ctypes.c_int
        lib.vcb_loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.vcb_loader_skipped_rows.restype = ctypes.c_longlong
        lib.vcb_loader_skipped_rows.argtypes = [ctypes.c_void_p]
        lib.vcb_loader_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        lib.vcb_loader_next.restype = ctypes.c_int
        lib.vcb_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32)]
        lib.vcb_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.vcb_write.restype = ctypes.c_int
        lib.vcb_write.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return lib


def _u8_ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_vcb(path: str, cad: np.ndarray, frames: np.ndarray,
              actions: np.ndarray, views: Optional[np.ndarray] = None):
    """Write one sequence as a ``.vcb`` file through the native writer.

    ``frames`` (T, H, W, C) uint8, ``actions`` (T, act_dim), ``cad`` (H, W,
    C) uint8. With ``views`` (V, H, W, C) the file is version 2; a ``cad``
    of another shape than a frame's (the GenCAD 256 x 256 x 3 edge image)
    makes it version 3; otherwise version 1.
    """
    lib = load_library()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    cad = np.ascontiguousarray(cad, dtype=np.uint8)
    actions = np.ascontiguousarray(actions, dtype=np.int32)
    t, h, w, c = frames.shape
    if cad.ndim != 3:
        raise ValueError(f"cad must be (H, W, C) uint8; got {cad.shape}")
    if actions.ndim != 2 or actions.shape[0] != t:
        # The writer reads t * act_dim int32s from this pointer: a shorter
        # array would be a heap over-read.
        raise ValueError(f"actions must be (T={t}, act_dim); "
                         f"got {actions.shape}")
    num_views = 0
    views_ptr = ctypes.POINTER(ctypes.c_uint8)()
    if views is not None:
        views = np.ascontiguousarray(views, dtype=np.uint8)
        if views.ndim != 4 or views.shape[1:] != (h, w, c):
            raise ValueError(f"views must be (V, {h}, {w}, {c}) uint8; got "
                             f"{views.shape}")
        num_views = views.shape[0]
        views_ptr = _u8_ptr(views)
    ok = lib.vcb_write(
        path.encode(), t, h, w, c, actions.shape[1], num_views,
        cad.shape[0], cad.shape[1], cad.shape[2], _u8_ptr(cad), views_ptr,
        _u8_ptr(frames),
        actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if not ok:
        raise IOError(f"failed to write {path}")


def convert_store_to_vcb(store_dir: str, out_dir: str,
                         ids: Optional[Sequence[str]] = None,
                         view_ids: Optional[Sequence[str]] = None,
                         multiview_dir: Optional[str] = None,
                         gencad: bool = False,
                         image_size: Optional[int] = None) -> int:
    """Convert a pickle store into ``.vcb`` shards, once; returns the count.

    With ``view_ids`` the multiview PNGs are packed into version-2 files.
    With ``gencad`` the CAD image is preprocessed here once (Canny edges,
    three channels, 256 x 256) and packed at its own shape (version 3).
    """
    from videocad_tpu_torch.data.dataset import VideoCADDataset

    dataset = VideoCADDataset(store_dir, ids=ids, view_ids=view_ids,
                              multiview_dir=multiview_dir, gencad=gencad,
                              image_size=image_size)
    for i in range(len(dataset)):
        item = dataset[i]
        frames = item["frames"]
        h, w, c = frames.shape[1:]
        cad = (item["cad_image"] if gencad
               else _match_channels(item["cad_image"], h, w, c))
        views = item.get("multiview_images")
        if views is not None:
            views = np.stack([_match_channels(v, h, w, c) for v in views])
        path = shard_path(out_dir, dataset.sequence_id(i), "vcb", "data")
        write_vcb(path, cad, frames, item["actions"].astype(np.int32),
                  views=views)
    return len(dataset)


def _match_channels(img: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Resize and reshape an image to the frames' (H, W, C) packing
    shape."""
    from PIL import Image

    if img.shape[:2] != (h, w):
        img = np.asarray(Image.fromarray(img).resize((w, h)))
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] != c:
        img = img[..., :c] if img.shape[-1] > c else np.repeat(img, c, -1)
    return img


def scan_vcb(root: str) -> list:
    """Every ``.vcb`` file under ``root``, sorted."""
    files = []
    for dirpath, _dirs, names in os.walk(root):
        files.extend(os.path.join(dirpath, n) for n in names
                     if n.endswith(".vcb"))
    files.sort()
    return files


class NativePipeline:
    """Padded batches assembled by the C++ loader, in ``DataPipeline``'s
    batch layout."""

    def __init__(self, paths: Sequence[str], batch_size: int, bucket_len: int,
                 image_shape=(224, 224, 3), act_dim: int = 7,
                 num_views: int = 0, cad_shape=None, shuffle: bool = True,
                 seed: int = 42, prefetch: int = 2, num_threads: int = 2,
                 host_id: int = 0, num_hosts: int = 1,
                 max_skipped_rows: int = 0,
                 rows: Optional[Tuple[int, int]] = None):
        """``host_id`` / ``num_hosts``: a disjoint slice of the shuffled
        order for each process, reshuffled every epoch. ``rows`` = (data
        rank r, data ranks dp): the rows ``[r * B / dp, (r + 1) * B / dp)``
        of each global batch of the single process's order, as
        ``DataPipeline`` takes them. The loader strides its host slices
        (host h reads positions h, h + H, ...), so row j of every global
        batch is host j of H = B reading one row a batch: the rank runs one
        such loader for each of its rows and joins them. ``num_views`` > 0
        reads version-2 files and yields ``multiview_images`` (B, V, H, W,
        C). ``cad_shape``: the CAD image's own (H, W, C) where it differs
        from a frame's (version-3 GenCAD stores). ``max_skipped_rows``:
        corrupt or mismatched rows are padded out and counted, and more
        than this many in an epoch raise."""
        if not paths:
            raise ValueError("no .vcb files given")
        if batch_size < 1 or bucket_len < 1:
            # batch_size 0 is a division by zero (SIGFPE) in the C++
            # num_batches(): refuse it here, with a traceback.
            raise ValueError(f"batch_size and bucket_len must be >= 1, got "
                             f"{batch_size}, {bucket_len}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(
                f"host_id {host_id} out of range [0, {num_hosts}): a "
                "misconfigured multi-host launch would duplicate shards")
        rows = check_rows(batch_size, rows)
        if rows is not None and num_hosts > 1:
            raise ValueError("rows and num_hosts > 1 are two shardings; "
                             "pass one")
        self.lib = load_library()
        self.paths = list(paths)
        self.batch_size = batch_size
        self.bucket_len = bucket_len
        self.h, self.w, self.c = image_shape
        self.cad_shape = tuple(cad_shape) if cad_shape else tuple(image_shape)
        self.act_dim = act_dim
        self.num_views = num_views
        self.shuffle = shuffle
        self.seed = seed
        self.max_skipped_rows = max_skipped_rows
        # next() never writes the views pointer without views: one dummy
        # serves every batch.
        self._dummy_views = np.empty((1,), np.uint8)
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        if rows is None:
            loaders = [(batch_size, host_id, num_hosts)]
        else:
            per = batch_size // rows[1]
            loaders = [(1, rows[0] * per + j, batch_size)
                       for j in range(per)]
        self._handles = []
        for size, host, hosts in loaders:
            handle = self.lib.vcb_loader_create(
                arr, len(self.paths), size, bucket_len,
                self.h, self.w, self.c, act_dim, num_views,
                self.cad_shape[0], self.cad_shape[1], self.cad_shape[2],
                prefetch, num_threads, host, hosts)
            if not handle:
                raise ValueError("vcb_loader_create failed (see stderr)")
            self._handles.append((handle, size))

    def __len__(self) -> int:
        return self.lib.vcb_loader_num_batches(self._handles[0][0])

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for handle, _ in self._handles:
            self.lib.vcb_loader_start_epoch(handle, epoch, self.seed,
                                            int(self.shuffle))
        while True:
            parts = [self._next(handle, size)
                     for handle, size in self._handles]
            if any(part is None for part in parts):
                skipped = self.skipped_rows()
                if skipped > self.max_skipped_rows:
                    raise RuntimeError(
                        f"native loader skipped {skipped} corrupt/"
                        f"shape-mismatched .vcb rows this epoch "
                        f"(max_skipped_rows={self.max_skipped_rows}); "
                        f"see stderr for the offending paths")
                return
            if len(parts) == 1:
                yield parts[0]
                continue
            yield {k: (sum((p[k] for p in parts), []) if k == "ids"
                       else np.concatenate([p[k] for p in parts]))
                   for k in parts[0]}

    def _next(self, handle, b: int) -> Optional[Dict[str, np.ndarray]]:
        """One batch of ``b`` rows from one C++ loader, or None at the end
        of its epoch."""
        l, v = self.bucket_len, self.num_views
        frames = np.empty((b, l, self.h, self.w, self.c), np.uint8)
        actions = np.empty((b, l, self.act_dim), np.float32)
        cad = np.empty((b,) + self.cad_shape, np.uint8)
        views = (np.empty((b, v, self.h, self.w, self.c), np.uint8)
                 if v > 0 else self._dummy_views)
        indices = np.empty((b,), np.int32)
        ok = self.lib.vcb_loader_next(
            handle, _u8_ptr(frames),
            actions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _u8_ptr(cad), _u8_ptr(views),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not ok:
            return None
        batch = {
            "frames": frames,
            "actions": actions,
            "cad_image": cad,
            "timesteps": np.tile(np.arange(l)[None], (b, 1)),
            "ids": [os.path.basename(self.paths[i]).split("_")[0]
                    for i in indices],
        }
        if v > 0:
            batch["multiview_images"] = views
        return batch

    def skipped_rows(self) -> int:
        """Corrupt or mismatched rows padded out so far this epoch."""
        return sum(int(self.lib.vcb_loader_skipped_rows(handle))
                   for handle, _ in self._handles)

    def __del__(self):
        for handle, _ in getattr(self, "_handles", ()):
            self.lib.vcb_loader_destroy(handle)
        self._handles = []
