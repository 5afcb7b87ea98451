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
import functools
from typing import Tuple

import torch

from videocad_tpu_torch.kernels import build

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
    shape = x.shape
    d = shape[-1] if shape else 0
    if not shape or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layer_norm takes x (..., D) and scale, bias (D,), "
                         f"got {tuple(shape)}, {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    device = x.device
    if scale.device != device or bias.device != device:
        raise ValueError("layer_norm takes x, scale and bias on one device")


def _check_kernel_inputs(x, *params) -> int:
    """What the kernels take, in one pass: x float32 or bfloat16, float32
    parameters, D <= 1,024. Returns the code of x's dtype."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for p in params:
        if p.dtype != torch.float32:
            raise TypeError("layer_norm kernel takes float32 scale and bias")
    if x.shape[-1] > _MAX_DIM:
        raise ValueError(f"layer_norm kernel takes D <= {_MAX_DIM}, got "
                         f"{x.shape[-1]}")
    return code


def _not_cpu_or_cuda(device) -> ValueError:
    return ValueError(f"layer_norm runs on CPU or CUDA, not {device}")


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")


# The kernels' instantiations, in the order of their variant codes
# (csrc/layernorm.cu: kFwdVariants, and kBwdVariants in the same order).
FWD_VARIANTS = ("float32/scalar", "float32/vector", "float32/512",
                "float32/1024", "bfloat16/scalar", "bfloat16/vector",
                "bfloat16/512", "bfloat16/1024")
BWD_VARIANTS = FWD_VARIANTS


def forward_variant(d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The forward kernel's instantiation for rows of width ``d`` (<= 1,024)
    of ``dtype`` (float32 or bfloat16); ``aligned``: x starts on a 16-byte
    boundary. The flagship's widths, 512 and 1,024, have kernels of their
    exact width; any other width on the 16-byte grid (a multiple of 4
    float32 or 8 bfloat16 values) the generic "vector" one; a width off it,
    or an unaligned x, the "scalar" one."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    if not aligned or d % (8 if dtype == torch.bfloat16 else 4):
        return name + "/scalar"
    return f"{name}/{d}" if d in (512, 1024) else name + "/vector"


def backward_variant(d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The backward kernel's instantiation: the forward's rule, where
    ``aligned`` says that x and g both start on a 16-byte boundary."""
    return forward_variant(d, dtype, aligned)


@functools.lru_cache(maxsize=None)
def _variant_code(d: int, dtype_code: int, aligned: bool) -> int:
    """forward_variant's (and backward_variant's) answer as the code the C
    entries take: its index in FWD_VARIANTS (BWD_VARIANTS)."""
    dtype = torch.bfloat16 if dtype_code else torch.float32
    return FWD_VARIANTS.index(forward_variant(d, dtype, aligned))


@functools.lru_cache(maxsize=256)
def _bwd_blocks(rows: int, d: int, code: int, device_index: int) -> int:
    """The partials' rows that the backward's instantiation ``code`` needs
    for ``rows`` rows of width ``d`` on CUDA device ``device_index`` (a
    grid that card holds at once), asked of the library, on that device,
    once per (rows, d, code, device)."""
    blocks = build.on_device((_entries or load_library())[2], device_index,
                             rows, d, code)
    if blocks < 1:
        raise RuntimeError(f"layer_norm backward: no launch plan for "
                           f"{rows} x {d} ({BWD_VARIANTS[code]})")
    return blocks


def _forward(x, scale, bias, eps):
    # The host's path to a launch is kept short: at the CAD encoder's 400
    # rows it takes longer than the kernel (PERF.md section 6).
    device = x.device
    if device.type != "cuda":
        if device.type == "cpu":
            return layer_norm_plain(x, scale, bias, eps)
        raise _not_cpu_or_cuda(device)
    dtype_code = _check_kernel_inputs(x, scale, bias)
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    d = x.shape[-1]
    ptr = x.data_ptr()
    code = _variant_code(d, dtype_code, ptr % 16 == 0)
    _raise_on(build.launch(
        (_entries or load_library())[0], device.index, ptr,
        scale.contiguous().data_ptr(), bias.contiguous().data_ptr(),
        y.data_ptr(), n // d, d, eps, code))
    layer_norm.launches += 1
    layer_norm.variant_launches[FWD_VARIANTS[code]] += 1
    return y


def layer_norm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                        eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of :func:`layer_norm` for the output gradient
    ``g``: on a CUDA tensor the row kernel and the kernel that sums its
    per-block parameter-gradient partials, counted as one launch of the
    backward (``layer_norm_backward.launches``, and by instantiation in
    ``.variant_launches``, :func:`backward_variant`); on a CPU tensor
    :func:`layer_norm_backward_plain`. ``g`` may be non-contiguous, as
    autograd may hand it over. dscale and dbias are two views of one (2, D)
    float32 tensor."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("layer_norm_backward takes g like x")
    device = x.device
    if device.type != "cuda":
        if device.type == "cpu":
            return layer_norm_backward_plain(x, scale, g, eps)
        raise _not_cpu_or_cuda(device)
    dtype_code = _check_kernel_inputs(x, scale)
    x, g = x.contiguous(), g.contiguous()
    d = x.shape[-1]
    dx = torch.empty_like(x)
    params = torch.empty((2, d), dtype=torch.float32, device=device)
    n = x.numel()
    if n == 0:
        params.zero_()
        return dx, params[0], params[1]
    rows = n // d
    xp, gp = x.data_ptr(), g.data_ptr()
    code = _variant_code(d, dtype_code, (xp | gp) % 16 == 0)
    nparts = _bwd_blocks(rows, d, code, device.index)
    parts = torch.empty((2, nparts, d), dtype=torch.float32, device=device)
    _raise_on(build.launch(
        (_entries or load_library())[1], device.index, xp,
        scale.contiguous().data_ptr(), gp, dx.data_ptr(), params.data_ptr(),
        parts.data_ptr(), nparts, rows, d, eps, code))
    layer_norm_backward.launches += 1
    layer_norm_backward.variant_launches[BWD_VARIANTS[code]] += 1
    return dx, params[0], params[1]


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
    ``layer_norm_backward.launches`` count those launches, and their
    ``variant_launches`` by instantiation (:func:`forward_variant`,
    :func:`backward_variant`). On a CPU tensor it runs the plain versions.
    """
    _check(x, scale, bias)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)


layer_norm.launches = 0
# The forward's launches by instantiation (FWD_VARIANTS).
layer_norm.variant_launches = dict.fromkeys(FWD_VARIANTS, 0)
layer_norm_backward.launches = 0
layer_norm_backward.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
_entries = None    # the C entries, once load_library has bound them


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries (``layer_norm_fwd``, ``layer_norm_bwd``,
    ``layer_norm_bwd_blocks``), bound once and kept for every later
    launch."""
    global _entries
    lib = build.load("layernorm")
    entries = []
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        entries.append(fn)
    _entries = tuple(entries)
    return _entries


def _signatures():
    """(restype, argtypes) of each C entry of ``csrc/layernorm.cu``."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    tail = [i64, i32, f32, i32, ptr]    # rows, d, eps, the variant, stream
    return {"layer_norm_fwd": (i32, [ptr] * 4 + tail),
            "layer_norm_bwd": (i32, [ptr] * 6 + [i32] + tail),
            "layer_norm_bwd_blocks": (i32, [i64, i32, i32])}
