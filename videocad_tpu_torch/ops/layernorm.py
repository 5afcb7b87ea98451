"""Row LayerNorm, forward and backward, for the ViT token stream.

Port of ``videocad_tpu/ops/layernorm.py:layer_norm``. flax ``nn.LayerNorm``
semantics over the last dim: statistics in float32 (the mean, then the
centred second moment), eps inside the rsqrt, ``y = (x - mean) * rstd *
scale + bias`` in float32, the output rounded once to the input dtype.
Autograd keeps only x and scale: the backward recomputes the statistics and
emits dx, dscale and dbias (the parameter gradients float32, summed over
rows inside the kernels, in a fixed order).

Dispatch: a CPU tensor runs the plain PyTorch versions beside the kernels
(:func:`layer_norm_plain`, :func:`layer_norm_backward_plain`); a CUDA
tensor launches the kernels (``csrc/layernorm.cu``) or raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 1024     # a warp holds a row in registers (csrc/layernorm.cu)


def _norm_and_rstd(x2: torch.Tensor, eps: float):
    """(rows, d) float32 -> (normalized rows, rstd (rows, 1))."""
    centered = x2 - x2.mean(dim=1, keepdim=True)
    var = (centered * centered).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return centered * rstd, rstd


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel."""
    norm, _ = _norm_and_rstd(x.reshape(-1, x.shape[-1]).to(torch.float32),
                             eps)
    y = norm * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype).reshape(x.shape)


def layer_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                              g: torch.Tensor, eps: float = 1e-6
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dx, dscale, dbias)
    for the output gradient ``g``, by the kernel's formula, not autograd."""
    d = x.shape[-1]
    norm, rstd = _norm_and_rstd(x.reshape(-1, d).to(torch.float32), eps)
    g2 = g.reshape(-1, d).to(torch.float32)
    gs = g2 * scale.to(torch.float32)
    m1 = gs.mean(dim=1, keepdim=True)
    m2 = (gs * norm).mean(dim=1, keepdim=True)
    dx = rstd * (gs - m1 - norm * m2)
    return (dx.to(x.dtype).reshape(x.shape), (g2 * norm).sum(dim=0),
            g2.sum(dim=0))


def _check(x, scale, bias):
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layer_norm takes x (..., D) and scale, bias (D,), "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("layer_norm takes x, scale and bias on one device")


def _check_kernel_inputs(x, *params):
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on CPU or CUDA, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("layer_norm kernel takes float32 scale and bias")
    if x.shape[-1] > _MAX_DIM:
        raise ValueError(f"layer_norm kernel takes D <= {_MAX_DIM}, got "
                         f"{x.shape[-1]}")


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")


def _forward(x, scale, bias, eps):
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _check_kernel_inputs(x, scale, bias)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    d = x.shape[-1]
    entries = _entries or load_library()
    with torch.cuda.device(x.device):
        _raise_on(entries[0](
            x.data_ptr(), scale.contiguous().data_ptr(),
            bias.contiguous().data_ptr(), y.data_ptr(), x.numel() // d, d,
            eps, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
    layer_norm.launches += 1
    return y


def layer_norm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                        eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of :func:`layer_norm` for the output gradient
    ``g``: on a CUDA tensor the row kernel and the kernel that sums its
    per-block parameter-gradient partials, counted as one launch of the
    backward (``layer_norm_backward.launches``); on a CPU tensor
    :func:`layer_norm_backward_plain`. ``g`` may be non-contiguous, as
    autograd may hand it over."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("layer_norm_backward takes g like x")
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, scale, g, eps)
    _check_kernel_inputs(x, scale)
    x, g = x.contiguous(), g.contiguous()
    d = x.shape[-1]
    dx = torch.empty_like(x)
    if x.numel() == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    rows = x.numel() // d
    entries = _entries or load_library()
    parts = torch.empty((2, entries[2](rows), d), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        _raise_on(entries[1](
            x.data_ptr(), scale.contiguous().data_ptr(), g.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            parts.data_ptr(), rows, d, eps, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
    layer_norm_backward.launches += 1
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """The forward and backward kernels under autograd; x and scale are
    all that is kept for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(x, scale, g, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim: x (..., D), scale and bias (D,); the
    output has x's dtype. Differentiable in x, scale and bias.

    On a CUDA tensor it launches the hand-written kernels, which take
    float32 or bfloat16 x, float32 scale and bias and D <= 1,024, and raises
    on anything else; ``layer_norm.launches`` and
    ``layer_norm_backward.launches`` count those launches. On a CPU tensor
    it runs the plain versions.
    """
    _check(x, scale, bias)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)


layer_norm.launches = 0
layer_norm_backward.launches = 0
_entries = None    # the C entries, once load_library has bound them


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries (``layer_norm_fwd``, ``layer_norm_bwd``,
    ``layer_norm_bwd_blocks``), bound once and kept for every later
    launch."""
    global _entries
    from videocad_tpu_torch.kernels import build

    lib = build.load("layernorm")
    tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
    fwd, bwd, blocks = (lib.layer_norm_fwd, lib.layer_norm_bwd,
                        lib.layer_norm_bwd_blocks)
    fwd.restype = bwd.restype = blocks.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + tail
    bwd.argtypes = [ctypes.c_void_p] * 7 + tail
    blocks.argtypes = [ctypes.c_longlong]
    _entries = (fwd, bwd, blocks)
    return _entries
