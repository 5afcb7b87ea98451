"""Elementwise dropout with integer-threshold masks.

Port of ``videocad_tpu/ops/dropout.py``: its ``dropout`` entry point with
both implementations, and ``hw_dropout``, the standalone kernel.

``impl="xla"`` compares raw random bits from a ``torch.Generator`` on the
tensor's device against an integer threshold, with the two rate rules of
the JAX package:

  * the u8 rule: ``threshold = round(rate * 256)``, so the drop rate
    quantizes to 1/256 (rate 0.1 realizes as 26/256); the keep scale uses
    that EFFECTIVE rate, so E[dropout(x)] == x exactly;
  * rates off the u8 grid (threshold 0 or 256) take an exact u32 threshold
    instead of quantizing to a multiple of the asked rate.

The numbers differ from JAX's for the same seed, the distributions do not.

``impl="pallas"`` is :func:`hw_dropout`: one pass that draws the bits
inside the kernel (``csrc/dropout.cu``), keeps an element where its 32 bits
reach the exact u32 threshold (rate 0.1 is 0.1, not 26/256), scales by
1/(1 - rate) in float32 and rounds once to the I/O dtype. No mask is
stored: the backward runs the same kernel on the cotangent with the same
seed. The bits are ``ops/prng.py:elementwise_bits``, a pure function of
(seed, flat element index), so the mask does not depend on the launch grid.
Each call draws its own seed on the host from ``DropoutRng.seeds``, so two
sites of one step never share a mask and nothing synchronises.

Dispatch of :func:`hw_dropout`: a CPU tensor runs the plain PyTorch version
beside the kernel (:func:`hw_dropout_plain`); a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other. The kernel
takes the rate itself and derives the threshold and the scale by the rules
above, in double precision as they are computed here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from videocad_tpu_torch.kernels import build
from videocad_tpu_torch.ops.prng import (derive_seed, dropout_threshold,
                                         elementwise_bits, fold_in, keep_mask)

# fold_in word of the per-model-rank stream of DropoutRng.sharded()
_SHARD_WORD = 1 << 20

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class DropoutRng:
    """The generators a training-mode forward draws from, made from one
    seed: ``seeds`` (on the CPU) yields the int32 seeds of the kernels'
    in-kernel dropout without touching the device, and ``bits`` (on the
    model's device) yields the elementwise sites' masks."""

    def __init__(self, seed: int, device="cpu",
                 model_rank: Optional[int] = None):
        self.seeds = torch.Generator().manual_seed(seed)
        self.bits = torch.Generator(device=device).manual_seed(seed)
        self._sharded = (self if model_rank is None else DropoutRng(
            fold_in(seed, _SHARD_WORD + model_rank), device))

    def sharded(self) -> "DropoutRng":
        """The generators of sites on activations that are split over the
        model axis (attention probabilities of split heads, a split FFN or
        MLP hidden layer): one stream a model rank, so that the ranks'
        shards do not share masks. Sites on replicated activations draw
        from this object itself, the same masks on every model rank, or
        the replicated stream would diverge between them. Without a model
        rank (one model rank) it is this object."""
        return self._sharded

    def generators(self):
        """Every generator that a forward draws from."""
        gens = [self.seeds, self.bits]
        if self._sharded is not self:
            gens += [self._sharded.seeds, self._sharded.bits]
        return gens


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")


def hw_dropout_plain(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, drawing the kernel's own mask:
    ``where(bits >= threshold, x * 1/(1 - rate), 0)`` over the row-major
    flat elements, the product in float32, rounded once to ``x.dtype``."""
    _check_rate(rate)
    bits = elementwise_bits(seed & 0xFFFFFFFF, x.numel(), x.device)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    scaled = x.to(torch.float32) * inv_keep.to(x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    keep = keep_mask(bits, rate).reshape(x.shape)
    return torch.where(keep, scaled, zero).to(x.dtype)


def _dtype_code(x: torch.Tensor) -> int:
    """The kernel's code for ``x``'s dtype; raises on one it does not
    take."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"hw_dropout kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    return code


def _apply(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    # The host's path to a launch is kept short: at the decoder's attention
    # weights it takes longer than the kernel (PERF.md section 6).
    device = x.device
    if device.type != "cuda":
        if device.type == "cpu":
            return hw_dropout_plain(x, seed, rate)
        raise ValueError(f"hw_dropout runs on CPU or CUDA, not {device}")
    code = _dtype_code(x)
    x = x.contiguous()    # the mask is defined on the row-major elements
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        err = build.launch(_entry or load_library(), device.index,
                           x.data_ptr(), out.data_ptr(), n, code,
                           seed & 0xFFFFFFFF, rate)
        if err:
            raise RuntimeError(f"hw_dropout kernel launch failed: CUDA "
                               f"error {err}")
        hw_dropout.launches += 1
    return out


class _HwDropout(torch.autograd.Function):
    """The kernel under autograd; only the seed is kept for the backward,
    which is the forward applied to the cotangent."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.args = (seed, rate)
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None


def hw_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout whose mask is a function of ``seed`` and the element index;
    differentiable, the mask never stored. ``x``: any shape; ``seed``: an
    int32 (``prng.derive_seed``); ``rate``: the drop probability, in
    [0, 1).

    On a CUDA tensor it launches the hand-written kernel, which takes
    float32 or bfloat16, and raises on anything else;
    ``hw_dropout.launches`` counts those launches, the backward's too. On a
    CPU tensor it runs :func:`hw_dropout_plain`.
    """
    _check_rate(rate)
    if torch.is_grad_enabled() and x.requires_grad:
        return _HwDropout.apply(x, seed, rate)
    return _apply(x, seed, rate)


hw_dropout.launches = 0
_entry = None    # the C entry, once load_library has bound it


def load_library():
    """Build (at first use) and load the kernel's library; returns its C
    entry ``hw_dropout``, bound once and kept for every later launch."""
    global _entry
    entry = build.load("dropout").hw_dropout
    entry.restype = ctypes.c_int
    entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_double,
                      ctypes.c_void_p]
    _entry = entry
    return _entry


def dropout(x: torch.Tensor, rng: DropoutRng, rate: float,
            impl: str = "xla") -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest so
    the expectation is unchanged; differentiable (the mask is a constant).
    Rate 0 returns ``x`` itself. ``impl``: ``"xla"`` (bits from
    ``rng.bits``, the u8 rule) or ``"pallas"`` (:func:`hw_dropout` with a
    seed drawn from ``rng.seeds``).
    """
    if rate == 0.0:
        return x
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown dropout impl {impl!r}")
    if rng is None:
        raise ValueError(f"dropout with rate {rate} needs a DropoutRng")
    if impl == "pallas":
        return hw_dropout(x, derive_seed(rng.seeds), rate)
    generator = rng.bits
    threshold = round(rate * 256)
    if not 1 <= threshold <= 255:
        bits = torch.randint(0, 2 ** 32, x.shape, dtype=torch.int64,
                             device=x.device, generator=generator)
        keep = bits >= dropout_threshold(rate)
        eff_rate = rate
    else:
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=generator)
        keep = bits >= threshold
        eff_rate = threshold / 256.0
    return torch.where(keep, x / (1.0 - eff_rate), 0.0)
