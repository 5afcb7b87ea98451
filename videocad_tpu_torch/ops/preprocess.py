"""On-device image preprocessing: uint8 RGB/BGR -> normalized grayscale,
with an optional bilinear-resize stage.

Port of ``videocad_tpu/ops/preprocess.py``'s plain path
(``grayscale_normalize``, ``normalize_only``, ``maybe_preprocess``). The
host ships raw uint8 frames and the conversion runs on the device:
out = gray / 127.5 - 1, optionally resized to the model's input size first.

Channel-order quirk, kept for parity: the reference stores frames BGR but
converts them as if RGB, i.e. the (0.299, 0.587, 0.114) weights apply
POSITIONALLY to the stored channels. ``bgr_as_rgb`` documents that intent
and does not change the math.

``preprocess_impl: "pallas"`` (the JAX config's name for its fused Pallas
kernel) selects :func:`grayscale_normalize_fused`: on a CUDA tensor the
hand-written kernels of ``csrc/gray_normalize.cu``, one for the plain
conversion and one with the bilinear resize inside; on a CPU tensor the
plain path above. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from videocad_tpu_torch.kernels import build

# ITU-R 601-2 luma weights.
_RGB_WEIGHTS = (0.299, 0.587, 0.114)


def _weights(channels: int, bgr_as_rgb: bool) -> np.ndarray:
    """Luma weights for ``channels`` input channels (1 or 3)."""
    del bgr_as_rgb  # positional weights either way (see module docstring)
    if channels == 1:
        return np.ones((1,), np.float32)
    if channels == 3:
        return np.asarray(_RGB_WEIGHTS, np.float32)
    raise ValueError(f"grayscale_normalize takes 1 or 3 channels, "
                     f"got {channels}")


@functools.lru_cache(maxsize=32)
def _resize_taps(in_size: int, out_size: int):
    """Bilinear taps per output index, half-pixel centers (cv2.INTER_LINEAR
    / PIL convention), edges clamped: (lo, hi, weight of lo, weight of hi)
    as int32 and float32 arrays of ``out_size`` entries. Where both taps
    land on one source index (a clamped edge), ``hi == lo``, the weight of
    lo is the f32 sum of the two and the weight of hi is 0."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    hi = np.clip(lo + 1, 0, in_size - 1)
    lo = np.clip(lo, 0, in_size - 1)
    w_lo = (1.0 - frac).astype(np.float32)
    w_hi = frac.astype(np.float32)
    same = lo == hi
    w_lo = np.where(same, w_lo + w_hi, w_lo)
    w_hi = np.where(same, np.float32(0.0), w_hi)
    return (lo.astype(np.int32), hi.astype(np.int32), w_lo, w_hi)


@functools.lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix of :func:`_resize_taps`."""
    lo, hi, w_lo, w_hi = _resize_taps(in_size, out_size)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    mat[rows, hi] = w_hi
    mat[rows, lo] = w_lo
    return mat


def _resize_2d(gray: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) via two matrix products."""
    h, w = gray.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return gray
    rh = torch.from_numpy(_resize_matrix(h, oh)).to(gray.device)
    rw = torch.from_numpy(_resize_matrix(w, ow)).to(gray.device)
    out = torch.einsum("oh,...hw->...ow", rh, gray)
    return torch.einsum("pw,...ow->...op", rw, out)


def grayscale_normalize(images: torch.Tensor, bgr_as_rgb: bool = False,
                        target_size: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """uint8 (..., H, W, C) -> float32 (..., H', W', 1) in [-1, 1].

    ``target_size=(H', W')`` adds the bilinear resize stage; None keeps the
    input resolution. C must be 1 or 3.
    """
    w = _weights(images.shape[-1], bgr_as_rgb)
    gray = None
    for c in range(images.shape[-1]):
        term = images[..., c].to(torch.float32) * float(w[c])
        gray = term if gray is None else gray + term
    if target_size is not None:
        gray = _resize_2d(gray, tuple(target_size))
    return (gray / 127.5 - 1.0)[..., None]


def normalize_only(images: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, C) -> float32 same shape in [-1, 1] (all channels)."""
    return images.to(torch.float32) / 127.5 - 1.0


def maybe_preprocess(images: torch.Tensor, bgr_as_rgb: bool = False,
                     impl: str = "xla",
                     target_size: Optional[Tuple[int, int]] = None,
                     mode: str = "grayscale") -> torch.Tensor:
    """Preprocess when the input is uint8; pass floats through unchanged.

    ``impl`` keeps the JAX config's names: ``"xla"`` is the plain path
    here, ``"pallas"`` the fused kernels.
    """
    if images.dtype != torch.uint8:
        return images
    if mode == "normalize_only":
        return normalize_only(images)
    if target_size is not None and tuple(images.shape[-3:-1]) == tuple(
            target_size):
        target_size = None
    if impl == "pallas":
        return grayscale_normalize_fused(images, bgr_as_rgb, target_size)
    return grayscale_normalize(images, bgr_as_rgb, target_size)


# ---------------------------------------------------------------------------
# The fused kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _luma(bgr_as_rgb: bool) -> Tuple[float, float, float]:
    """The three luma weights as the kernels' C entries take them."""
    return tuple(float(x) for x in _weights(3, bgr_as_rgb))


@functools.lru_cache(maxsize=32)
def _device_taps(in_size: int, out_size: int, device: torch.device):
    # One copy per device and size pair: a host-to-device copy on every
    # call would synchronise the step.
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _resize_taps(in_size, out_size))


def _check_kernel_inputs(images: torch.Tensor) -> None:
    """What the kernels take: uint8 (..., H, W, 3)."""
    if images.dtype != torch.uint8 or images.dim() < 3:
        raise TypeError("grayscale_normalize_fused kernel takes uint8 "
                        f"(..., H, W, 3), got {images.dtype} "
                        f"{tuple(images.shape)}")


def grayscale_normalize_fused(images: torch.Tensor, bgr_as_rgb: bool = False,
                              target_size: Optional[Tuple[int, int]] = None
                              ) -> torch.Tensor:
    """Fused u8 -> gray [-> resize] -> normalize: uint8 (..., H, W, 3) ->
    float32 (..., H', W', 1), the function of :func:`grayscale_normalize`.

    On a CUDA tensor it launches the hand-written kernels
    (``gray_normalize``, or ``gray_resize_normalize`` when ``target_size``
    differs from the input's), counted in
    ``grayscale_normalize_fused.launches`` and ``.resize_launches``, and
    raises on what they do not take; a non-contiguous input is copied once.
    On a CPU tensor, and for 1-channel input (nothing to fuse), it runs the
    plain path.
    """
    # The host's path to a launch is kept short: at the CAD image's size it
    # takes longer than the kernel (PERF.md section 6).
    device = images.device
    if images.shape[-1] != 3 or device.type == "cpu":
        return grayscale_normalize(images, bgr_as_rgb, target_size)
    if device.type != "cuda":
        raise ValueError("grayscale_normalize_fused runs on CPU or CUDA, "
                         f"not {device}")
    _check_kernel_inputs(images)
    shape = images.shape
    h, w = shape[-3], shape[-2]
    resize = target_size is not None and tuple(target_size) != (h, w)
    oh, ow = tuple(target_size) if resize else (h, w)
    out = torch.empty(shape[:-3] + (oh, ow, 1), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out
    images = images.contiguous()
    n = images.numel() // (h * w * 3)
    plain, resized = _entries or load_library()
    if resize:
        taps = _device_taps(h, oh, device) + _device_taps(w, ow, device)
        err = build.launch(resized, device.index, images.data_ptr(),
                           out.data_ptr(), n, h, w, oh, ow,
                           *[t.data_ptr() for t in taps],
                           *_luma(bgr_as_rgb))
    else:
        err = build.launch(plain, device.index, images.data_ptr(),
                           out.data_ptr(), n * h * w, *_luma(bgr_as_rgb))
    if err != 0:
        raise RuntimeError("grayscale_normalize_fused kernel launch failed: "
                           f"CUDA error {err}")
    if resize:
        grayscale_normalize_fused.resize_launches += 1
    else:
        grayscale_normalize_fused.launches += 1
    return out


grayscale_normalize_fused.launches = 0          # gray_normalize
grayscale_normalize_fused.resize_launches = 0   # gray_resize_normalize
_entries = None    # the C entries, once load_library has bound them


def _signatures():
    """(restype, argtypes) of each C entry of ``csrc/gray_normalize.cu``."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    # Pointers and the stream as c_void_p: without argtypes ctypes would
    # pass each Python int as a 32-bit int and cut the pointer.
    return {"gray_normalize": (i32, [ptr] * 2 + [i64] + [f32] * 3 + [ptr]),
            "gray_resize_normalize": (i32, [ptr] * 2 + [i32] * 5 + [ptr] * 8
                                      + [f32] * 3 + [ptr])}


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries (``gray_normalize``, ``gray_resize_normalize``), bound once."""
    global _entries
    lib = build.load("gray_normalize")
    entries = []
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        entries.append(fn)
    _entries = tuple(entries)
    return _entries
