"""Fused multi-head self-attention for short sequences (the ViT hot path).

Port of ``videocad_tpu/ops/fused_attention.py:mhsa_short``, forward and
backward, with dropout on the attention weights inside the kernels.
q, k and v stay in the (B, T, H*D) layout the projections produce; the
head split happens inside the kernels (``csrc/mhsa_short.cu``), so no
transpose runs around them. The math: scores = q k^T with f32
accumulation, times 1/sqrt(D); a row softmax in f32; dropout (kept weights
times 1/(1 - rate)) in f32; the weights cast to the I/O dtype; P V with
f32 accumulation; the output in the I/O dtype. The backward recomputes the
weights and redraws the mask from the seed, so autograd keeps only q, k, v
and the seed, never the weights or the mask.

The mask comes from ``ops/prng.py:dropout_bits``, a pure function of
(seed, batch row, head, query, key) that the kernels and the plain versions
here both compute, so they draw the same mask.

Dispatch: a CPU tensor runs the plain PyTorch versions beside the kernels
(:func:`mhsa_short_reference`, :func:`mhsa_short_backward_reference`); a
CUDA tensor launches the kernels or raises. There is no fallback from one
to the other. Of the kernels, :func:`_kernel_variant` picks one of two
variants from the dtype and the shape alone: "tc" (bfloat16 on the tensor
cores) or "scalar" (float32, and head widths the tensor-core tiles do not
take), each in two instantiations by T: the one for T <= 64 (the ViT at
224²: T = 50), and past it the wide one, up to T = 128 (the GenCAD CAD
encoder: T = 65), whose variant names end in ``_wide``. None stands in for
another when a launch fails.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from videocad_tpu_torch.kernels import build
from videocad_tpu_torch.ops.prng import dropout_bits, keep_mask, require_seed

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NARROW_SEQ = 64    # the first instantiation pads T to 64 (mhsa_short.cu)
_MAX_SEQ = 128      # the wide one, to 128
_MAX_HEAD_DIM = 64
# The variants and the prefix of their C entries (``<prefix>fwd``,
# ``<prefix>bwd``).
VARIANTS = {"scalar": "mhsa_short_", "tc": "mhsa_short_tc_",
            "scalar_wide": "mhsa_short_wide_",
            "tc_wide": "mhsa_short_tc_wide_"}


@functools.lru_cache(maxsize=None)
def _kernel_variant(dtype: torch.dtype, seq: int, head_dim: int) -> str:
    """The kernel variant for a CUDA call: "tc" for bfloat16 with D a
    multiple of 16 up to 64, "scalar" for everything else the kernels take
    (float32: the tensor cores would round it to TF32); with ``_wide``
    appended past T = 64 (the wide instantiation). Cached per (dtype,
    shape)."""
    variant = ("tc" if dtype == torch.bfloat16 and head_dim % 16 == 0
               and 16 <= head_dim <= _MAX_HEAD_DIM else "scalar")
    return variant + "_wide" if seq > _NARROW_SEQ else variant


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D) in float32."""
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).permute(
        0, 2, 1, 3).to(torch.float32)


def _merge_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D) in ``dtype``."""
    b, h, t, d = x.shape
    return x.to(dtype).permute(0, 2, 1, 3).reshape(b, t, h * d)


def _weights_and_mask(qh, kh, seed, dropout_rate):
    """The f32 softmax weights (B, H, T, T), and the keep mask or None."""
    b, h, t, d = qh.shape
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate == 0.0:
        return weights, None
    bits = dropout_bits(seed, b, h, t, t, device=qh.device)
    return weights, keep_mask(bits, dropout_rate)


def mhsa_short_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seed: Optional[int], num_heads: int,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (B, T, H*D) ->
    (B, T, H*D)."""
    require_seed(seed, dropout_rate, "mhsa_short")
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    weights, keep = _weights_and_mask(qh, kh, seed, dropout_rate)
    if keep is not None:
        weights = torch.where(keep, weights * (1.0 / (1.0 - dropout_rate)),
                              0.0)
    weights = weights.to(q.dtype).to(torch.float32)
    return _merge_heads(torch.matmul(weights, vh), q.dtype)


def mhsa_short_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        seed: Optional[int], num_heads: int, dropout_rate: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) for the
    output gradient ``g``. It follows the kernel's formula and rounding
    points (the dropped weights and ds drop to the I/O dtype before the
    products that consume them), not autograd."""
    require_seed(seed, dropout_rate, "mhsa_short")
    io = q.dtype
    qh, kh, vh, gh = (_split_heads(x, num_heads) for x in (q, k, v, g))
    weights, keep = _weights_and_mask(qh, kh, seed, dropout_rate)
    d_dropped = torch.matmul(gh, vh.transpose(-1, -2))
    if keep is None:
        dropped, dw = weights, d_dropped
    else:
        inv_keep = 1.0 / (1.0 - dropout_rate)
        dropped = torch.where(keep, weights * inv_keep, 0.0)
        dw = torch.where(keep, d_dropped * inv_keep, 0.0)
    dv = torch.matmul(dropped.to(io).to(torch.float32).transpose(-1, -2), gh)
    ds = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    ds = (ds * (1.0 / math.sqrt(qh.shape[-1]))).to(io).to(torch.float32)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_merge_heads(x, io) for x in (dq, dk, dv))


def _check(q, k, v, num_heads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"mhsa_short takes q, k, v of one (B, T, H*D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"mhsa_short takes one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("mhsa_short takes q, k, v on one device")
    if q.shape[-1] % num_heads:
        raise ValueError(f"width {q.shape[-1]} is not a multiple of "
                         f"{num_heads} heads")


def _not_cpu_or_cuda(device) -> ValueError:
    return ValueError(f"mhsa_short runs on CPU or CUDA, not {device}")


def _check_kernel_inputs(tensors, num_heads) -> Tuple[int, int, int]:
    """What the kernels take, in one pass: float32 or bfloat16, T <= 128,
    D <= 64, contiguous ``tensors`` (q first). Returns (B, T, D)."""
    first = tensors[0]
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"mhsa_short kernel takes float32 or bfloat16, "
                        f"got {first.dtype}")
    b, t, hd = first.shape
    head_dim = hd // num_heads
    if t > _MAX_SEQ or head_dim > _MAX_HEAD_DIM:
        raise ValueError(f"mhsa_short kernel takes T <= {_MAX_SEQ} and "
                         f"D <= {_MAX_HEAD_DIM}, got T={t}, D={head_dim}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("mhsa_short kernel takes contiguous q, k, v")
    return b, t, head_dim


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data does not start on 16 bytes
    (the tc variant moves 16 bytes an access)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(pick, counted, tensors, device, shape, num_heads, seed,
            dropout_rate) -> None:
    """Launch entry ``pick`` (0 forward, 1 backward) of the variant that the
    dtype and ``shape`` (B, T, D) take, on ``tensors`` (q first), through
    ``kernels/build.py:launch``; counts the launch on ``counted`` (the
    wrapper): ``launches``, ``tc_launches`` for a tc variant,
    ``wide_launches`` for the wide instantiation. The C entry derives the
    scores' scale and the dropout's cutoff and keep scale."""
    b, t, head_dim = shape
    dtype = tensors[0].dtype
    variant = _kernel_variant(dtype, t, head_dim)
    err = build.launch(
        (_entries or load_library())[variant][pick], device.index,
        *[x.data_ptr() for x in tensors], b, t, num_heads, head_dim,
        _DTYPE_CODES[dtype], seed & 0xFFFFFFFF if dropout_rate else 0,
        dropout_rate)
    if err != 0:
        raise RuntimeError(f"mhsa_short {variant} kernel launch failed: "
                           f"CUDA error {err}")
    counted.launches += 1
    if variant.startswith("tc"):
        counted.tc_launches += 1
    if variant.endswith("_wide"):
        counted.wide_launches += 1


def _forward(q, k, v, seed, num_heads, dropout_rate):
    # The host's path to a launch is kept short: at a serving tick's 8
    # frames it takes longer than the kernel (PERF.md section 6).
    device = q.device
    if device.type != "cuda":
        if device.type == "cpu":
            return mhsa_short_reference(q, k, v, seed, num_heads,
                                        dropout_rate)
        raise _not_cpu_or_cuda(device)
    shape = _check_kernel_inputs((q, k, v), num_heads)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    q, k, v = (_aligned(x) for x in (q, k, v))
    _launch(0, mhsa_short, (q, k, v, out), device, shape, num_heads, seed,
            dropout_rate)
    return out


def mhsa_short_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, seed: Optional[int], num_heads: int,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`mhsa_short` for the output gradient ``g``, in
    one kernel launch on a CUDA tensor (``mhsa_short_backward.launches``
    counts them, ``.tc_launches`` those of the tc variant,
    ``.wide_launches`` those of the wide instantiation), by
    :func:`mhsa_short_backward_reference` on a CPU tensor. ``g`` may be
    non-contiguous, as autograd may hand it over."""
    _check(q, k, v, num_heads)
    require_seed(seed, dropout_rate, "mhsa_short")
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("mhsa_short_backward takes g like q")
    device = q.device
    if device.type != "cuda":
        if device.type == "cpu":
            return mhsa_short_backward_reference(q, k, v, g, seed, num_heads,
                                                 dropout_rate)
        raise _not_cpu_or_cuda(device)
    g = g.contiguous()
    shape = _check_kernel_inputs((q, k, v, g), num_heads)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    q, k, v, g = (_aligned(x) for x in (q, k, v, g))
    _launch(1, mhsa_short_backward, (q, k, v, g, dq, dk, dv), device, shape,
            num_heads, seed, dropout_rate)
    return dq, dk, dv


class _MhsaShort(torch.autograd.Function):
    """The forward and backward kernels under autograd; q, k, v and the
    seed are all that is kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, seed, num_heads, dropout_rate):
        ctx.save_for_backward(q, k, v)
        ctx.args = (seed, num_heads, dropout_rate)
        return _forward(q, k, v, seed, num_heads, dropout_rate)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = mhsa_short_backward(*ctx.saved_tensors, g, *ctx.args)
        return dq, dk, dv, None, None, None


def mhsa_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               seed: Optional[int], num_heads: int,
               dropout_rate: float = 0.0) -> torch.Tensor:
    """Fused bidirectional MHSA: q, k, v (B, T, H*D) -> (B, T, H*D).

    ``seed``: an int32 for the in-kernel dropout (``prng.derive_seed``),
    ignored (may be None) when ``dropout_rate`` is 0. Differentiable in q,
    k and v.

    On a CUDA tensor it launches the hand-written kernels, which take
    float32 or bfloat16, contiguous inputs, T <= 128 and D <= 64, and
    raises on anything else; ``mhsa_short.launches`` and
    ``mhsa_short_backward.launches`` count those launches, their
    ``tc_launches`` the launches of the tensor-core variant and their
    ``wide_launches`` those of the instantiation for 64 < T <= 128
    (:func:`_kernel_variant`). On a CPU tensor it runs the plain
    versions.
    """
    _check(q, k, v, num_heads)
    require_seed(seed, dropout_rate, "mhsa_short")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} is not in [0, 1)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MhsaShort.apply(q, k, v, seed, num_heads, dropout_rate)
    return _forward(q, k, v, seed, num_heads, dropout_rate)


mhsa_short.launches = 0
mhsa_short.tc_launches = 0
mhsa_short.wide_launches = 0
mhsa_short_backward.launches = 0
mhsa_short_backward.tc_launches = 0
mhsa_short_backward.wide_launches = 0
_entries = None    # the C entries, once load_library has bound them


def _signatures():
    """(restype, argtypes) of each C entry of ``csrc/mhsa_short.cu``."""
    ptr, i32, u32, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_double)
    # Pointers and the stream as c_void_p: without argtypes ctypes would
    # pass each Python int as a 32-bit int and cut the pointer. After the
    # tensors: B, T, H, D, the dtype code, the seed, the dropout rate.
    tail = [i32] * 5 + [u32, f64, ptr]
    return {prefix + name: (i32, [ptr] * tensors + tail)
            for prefix in VARIANTS.values()
            for name, tensors in (("fwd", 4), ("bwd", 7))}


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries by variant, ``{"scalar": (mhsa_short_fwd, mhsa_short_bwd),
    "tc": (mhsa_short_tc_fwd, mhsa_short_tc_bwd), "scalar_wide":
    (mhsa_short_wide_fwd, ...), "tc_wide": (mhsa_short_tc_wide_fwd,
    ...)}``, bound once and kept for every later launch."""
    global _entries
    lib = build.load("mhsa_short")
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _entries = {variant: (getattr(lib, prefix + "fwd"),
                          getattr(lib, prefix + "bwd"))
                for variant, prefix in VARIANTS.items()}
    return _entries
