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

The fused Pallas kernel of the JAX package (``preprocess_impl: "pallas"``)
is not ported yet (ROADMAP kernel K2).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

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
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, half-pixel centers
    (cv2.INTER_LINEAR / PIL convention), edges clamped."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    hi = np.clip(lo + 1, 0, in_size - 1)
    lo = np.clip(lo, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, hi), frac.astype(np.float32))
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
    here; ``"pallas"`` (the fused kernel) is not ported yet.
    """
    if images.dtype != torch.uint8:
        return images
    if mode == "normalize_only":
        return normalize_only(images)
    if target_size is not None and tuple(images.shape[-3:-1]) == tuple(
            target_size):
        target_size = None
    if impl == "pallas":
        raise NotImplementedError(
            "preprocess_impl='pallas' needs the fused grayscale kernel, "
            "not ported yet (ROADMAP kernel K2); use 'xla'")
    return grayscale_normalize(images, bgr_as_rgb, target_size)
