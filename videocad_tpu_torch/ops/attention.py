"""Flash attention for the decoder: fused forward, dQ and dK/dV kernels,
dropout inside the kernels.

Port of ``videocad_tpu/ops/attention.py:flash_attention``. It computes
``dropout(softmax(q k^T / sqrt(d), mask)) v`` for q (B, T, H, D) and k, v
(B, S, H, D) without ever holding a (T, S) tensor in device memory: the
kernels (``csrc/flash_attention.cu``) stream key tiles with the running
(max, denominator) recurrence, read the heads by strides out of the
(B, T, H, D) layout the projections produce, and keep of the forward only
the output and the per-row logsumexp. Scores, softmax statistics and every
sum are float32 whatever the I/O dtype, as in the TPU kernel; dropout
multiplies the unnormalised weights and the denominator sums the undropped
ones. The plain versions here keep the weights and ds in float32 up to
the products that consume them (``xla_attention`` rounds the weights to
the I/O dtype first); the bfloat16 kernels round them to bfloat16 there.

Masks. The two masks the model builds come as a :class:`BandMask`, a
description by indices (``col <= row``, and ``col > row - window`` for the
banded window): the kernels then compute the mask themselves and skip the
key tiles that lie wholly outside it. Any other (T, S) bool tensor is read
by the kernels as it is. A query row whose mask admits no column is out of
contract (the model never builds one: both masks admit ``col == row``);
its output is undefined and must not be compared.

The dropout mask comes from ``ops/prng.py:dropout_bits`` under the flash
kernels' own key word: a pure function of (seed, batch row, head, query,
key), so the forward, dQ and dK/dV kernels and the plain versions here all
draw one mask, whatever their tiling.

Dispatch: a CPU tensor runs the plain PyTorch versions
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`); a CUDA tensor launches the
kernels or raises. There is no fallback from one to the other. Of the
kernels, :func:`_kernel_variant` picks one of two variants from the dtype
and the head width alone: "tc" (bfloat16 on the tensor cores, which round
the dropped weights and ds to bfloat16 before the products that consume
them, as the TPU kernels' ``precision=None`` products do) or "scalar"
(float32, and head widths the tensor-core tiles do not take); neither
stands in for the other when a launch fails.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from videocad_tpu_torch.kernels import build
# 16-byte aligned inputs for the tc variant, as the short-sequence
# kernels' tc variant takes them.
from videocad_tpu_torch.ops.fused_attention import _aligned
from videocad_tpu_torch.ops.prng import (FLASH_KEY_WORD, dropout_bits,
                                         keep_mask, require_seed)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256          # the kernels' widest head (csrc/flash_attention.cu)
_MAX_GRID_Y = 65535         # batch * heads rides the grid's y dimension
_NEG_INF = -1e30
_MASK_NONE, _MASK_BAND, _MASK_TENSOR = 0, 1, 2
_NO_WINDOW = 1 << 30        # a band as wide as any sequence: causal


class BandMask(NamedTuple):
    """A (q_len, kv_len) attention mask given by indices: row ``t`` attends
    columns ``col <= t``, and only ``col > t - window`` when ``window`` is
    set. ``window=None`` is the causal mask."""

    q_len: int
    kv_len: int
    window: Optional[int] = None

    def tensor(self, device=None) -> torch.Tensor:
        """The same mask as a (q_len, kv_len) bool tensor, True = attend."""
        rows = torch.arange(self.q_len, device=device)[:, None]
        cols = torch.arange(self.kv_len, device=device)[None, :]
        mask = cols <= rows
        if self.window is not None:
            mask = mask & (cols > rows - self.window)
        return mask


Mask = Optional[Union[torch.Tensor, BandMask]]


def _check_band(mask: BandMask, t: int, s: int) -> None:
    if (mask.q_len, mask.kv_len) != (t, s):
        raise ValueError(f"a BandMask of ({mask.q_len}, {mask.kv_len}) for "
                         f"attention of ({t}, {s})")
    if mask.window is not None and not 1 <= mask.window <= _NO_WINDOW:
        raise ValueError(f"a BandMask window of {mask.window}")


def _mask_tensor(mask: Mask, t: int, s: int, device) -> Optional[torch.Tensor]:
    """``mask`` as a (T, S) bool tensor, or None for no mask."""
    if mask is None:
        return None
    if isinstance(mask, BandMask):
        _check_band(mask, t, s)
        return mask.tensor(device)
    if mask.dtype != torch.bool or mask.dim() > 2:
        raise ValueError("flash_attention takes a bool mask broadcastable to "
                         f"(T, S), got {mask.dtype} {tuple(mask.shape)}")
    return mask.to(device).expand(t, s)


def _scores_and_mask(q, k, mask: Mask, seed, dropout_rate):
    """Scaled scores (B, H, T, S) in float32, the mask tensor or None, and
    the dropout factor (keep / (1 - rate)) or None."""
    b, t, h, d = q.shape
    s = k.shape[1]
    q_scaled = q.to(torch.float32) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bthd,bshd->bhts", q_scaled, k.to(torch.float32))
    allowed = _mask_tensor(mask, t, s, q.device)
    drop = None
    if dropout_rate > 0.0:
        bits = dropout_bits(seed, b, h, t, s, device=q.device,
                            key_word=FLASH_KEY_WORD)
        drop = keep_mask(bits, dropout_rate).to(torch.float32) * (
            1.0 / (1.0 - dropout_rate))
    return scores, allowed, drop


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask: Mask = None,
                              seed: Optional[int] = None,
                              dropout_rate: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (out (B, T, H, D) in
    q's dtype, lse (B, H, T) float32)."""
    require_seed(seed, dropout_rate, "flash_attention")
    scores, allowed, drop = _scores_and_mask(q, k, mask, seed, dropout_rate)
    if allowed is not None:
        scores = torch.where(allowed, scores, _NEG_INF)
    top = scores.max(dim=-1, keepdim=True).values
    p = torch.exp(scores - top)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if drop is not None:
        p = p * drop
    out = torch.einsum("bhts,bshd->bthd", p / denom, v.to(torch.float32))
    return out.to(q.dtype), (top + torch.log(denom))[..., 0]


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Mask,
        seed: Optional[int], out: torch.Tensor, lse: torch.Tensor,
        g: torch.Tensor, dropout_rate: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) for
    the output gradient ``g``, by the kernels' formulas: the weights
    recomputed from q, k and lse, ``delta = rowsum(g * out)``,
    ``ds = w * (dw * drop - delta)``."""
    require_seed(seed, dropout_rate, "flash_attention")
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores, allowed, drop = _scores_and_mask(q, k, mask, seed, dropout_rate)
    weights = torch.exp(scores - lse[..., None])
    if allowed is not None:
        weights = torch.where(allowed, weights, 0.0)
    g32, v32 = g.to(torch.float32), v.to(torch.float32)
    dw = torch.einsum("bthd,bshd->bhts", g32, v32)
    dropped = weights
    if drop is not None:
        dw = dw * drop
        dropped = weights * drop
    delta = (g32 * out.to(torch.float32)).sum(dim=-1).permute(0, 2, 1)
    ds = weights * (dw - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.to(torch.float32) * scale)
    dv = torch.einsum("bhts,bthd->bshd", dropped, g32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant for a CUDA call: "tc" for bfloat16 with D a
    multiple of 16 from 16 to 256, "scalar" for everything else the
    kernels take (float32: the tensor cores would round it to TF32).
    Cached per (dtype, head width)."""
    if (dtype == torch.bfloat16 and head_dim % 16 == 0
            and 16 <= head_dim <= MAX_HEAD_DIM):
        return "tc"
    return "scalar"


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            q.shape[0], q.shape[2], q.shape[3]) != (
            k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"flash_attention takes q (B, T, H, D) and k, v "
                         f"(B, S, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"flash_attention takes one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention takes q, k, v on one device")


def _check_kernel_inputs(device, *tensors):
    """What the kernels take, in one pass over ``tensors`` (q first) on
    ``device``, q's: CUDA tensors of float32 or bfloat16, head width
    1..256, batch * heads <= 65,535, contiguous."""
    first = tensors[0]
    if device.type != "cuda":
        raise ValueError(f"the flash_attention kernels take CUDA tensors, "
                         f"got {device}")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {first.dtype}")
    b, _, h, d = first.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D <= {MAX_HEAD_DIM}, "
                         f"got D={d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention kernel takes B * H <= "
                         f"{_MAX_GRID_Y}, got {b * h}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous q, k, v")


def _mask_args(mask: Mask, t: int, s: int, device):
    """(mode, window, the contiguous (T, S) mask tensor or None) as the C
    entries take them."""
    if mask is None:
        return _MASK_NONE, 0, None
    if isinstance(mask, BandMask):
        _check_band(mask, t, s)
        window = _NO_WINDOW if mask.window is None else mask.window
        return _MASK_BAND, window, None
    return _MASK_TENSOR, 0, _mask_tensor(mask, t, s, device).contiguous()


def _launch(pick, tensors, q, k, device, mask: Mask, seed,
            dropout_rate) -> str:
    """Launch entry ``pick`` (0 forward, 1 dQ, 2 dK/dV) of the variant the
    dtype and head width take on ``tensors`` (on ``device``), through
    ``kernels/build.py:launch``; returns the variant. The C entry derives
    the scores' scale and the dropout's cutoff and keep scale."""
    b, t, h, d = q.shape
    s = k.shape[1]
    dtype = q.dtype
    variant = _kernel_variant(dtype, d)
    mode, window, tensor = _mask_args(mask, t, s, device)
    err = build.launch(
        (_entries or load_library())[variant][pick], device.index,
        *[x.data_ptr() for x in tensors],
        None if tensor is None else tensor.data_ptr(), b, t, s, h, d,
        _DTYPE_CODES[dtype], mode, window,
        seed & 0xFFFFFFFF if dropout_rate else 0, dropout_rate)
    if err != 0:
        raise RuntimeError(f"flash_attention {variant} kernel launch "
                           f"failed: CUDA error {err}")
    return variant


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: Mask = None, seed: Optional[int] = None,
                            dropout_rate: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, T, H, D), lse (B, H, T) float32): one launch of the forward
    kernel on a CUDA tensor (``flash_attention.launches`` counts them,
    ``.tc_launches`` those of the tc variant),
    :func:`flash_attention_reference` on a CPU tensor."""
    _check(q, k, v)
    require_seed(seed, dropout_rate, "flash_attention")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} is not in [0, 1)")
    # The host's path to a launch is kept short: at the decoder's shapes it
    # takes longer than the kernels (PERF.md section 6).
    device = q.device
    if device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, seed, dropout_rate)
    _check_kernel_inputs(device, q, k, v)
    b, t, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=device)
    if q.numel() == 0:
        return out, lse
    if k.shape[1] == 0:
        raise ValueError("flash_attention over no keys")
    q, k, v = (_aligned(x) for x in (q, k, v))
    if _launch(0, (q, k, v, out, lse), q, k, device, mask, seed,
               dropout_rate) == "tc":
        flash_attention.tc_launches += 1
    flash_attention.launches += 1
    return out, lse


def flash_attention_dq(q, k, v, mask: Mask, seed, out, lse, g,
                       dropout_rate: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, delta (B, H, T) float32) from one launch of the dQ kernel, which
    also computes ``delta = rowsum(g * out)`` for the dK/dV kernel
    (``flash_attention_dq.launches`` counts them, ``.tc_launches`` those of
    the tc variant). CUDA tensors only."""
    device = q.device
    _check_kernel_inputs(device, q, k, v, g, out, lse)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    q, k, v, g, out = (_aligned(x) for x in (q, k, v, g, out))
    if _launch(1, (q, k, v, g, out, lse, dq, delta), q, k, device, mask,
               seed, dropout_rate) == "tc":
        flash_attention_dq.tc_launches += 1
    flash_attention_dq.launches += 1
    return dq, delta


def flash_attention_dkv(q, k, v, mask: Mask, seed, lse, delta, g,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from one launch of the dK/dV kernel, given the forward's
    lse and the dQ kernel's delta (``flash_attention_dkv.launches`` counts
    them, ``.tc_launches`` those of the tc variant). CUDA tensors only."""
    device = q.device
    _check_kernel_inputs(device, q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    q, k, v, g = (_aligned(x) for x in (q, k, v, g))
    if _launch(2, (q, k, v, g, lse, delta, dk, dv), q, k, device, mask,
               seed, dropout_rate) == "tc":
        flash_attention_dkv.tc_launches += 1
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Mask,
        seed: Optional[int], out: torch.Tensor, lse: torch.Tensor,
        g: torch.Tensor, dropout_rate: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``g``, given the forward's ``out`` and ``lse``: the dQ kernel, then the
    dK/dV kernel, on CUDA tensors; the plain version on CPU tensors. No
    output is written with atomics, so the gradients repeat bit for bit.
    ``g`` may be non-contiguous, as autograd may hand it over."""
    _check(q, k, v)
    require_seed(seed, dropout_rate, "flash_attention")
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("flash_attention_backward takes g like q")
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, mask, seed, out,
                                                  lse, g, dropout_rate)
    g = g.contiguous()
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_attention_dq(q, k, v, mask, seed, out, lse, g,
                                   dropout_rate)
    dk, dv = flash_attention_dkv(q, k, v, mask, seed, lse, delta, g,
                                 dropout_rate)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The three kernels under autograd. Kept for the backward: q, k, v,
    out, lse (and the mask tensor on the general path), the mask's
    description and the seed; nothing of size T x S on the index path."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, dropout_rate):
        out, lse = flash_attention_forward(q, k, v, mask, seed, dropout_rate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mask, seed, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mask, seed, dropout_rate = ctx.args
        dq, dk, dv = flash_attention_backward(q, k, v, mask, seed, out, lse,
                                              g, dropout_rate)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Mask = None, seed: Optional[int] = None,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """dropout(softmax(q k^T / sqrt(d), mask)) v, fused and trainable.

    q: (B, T, H, D); k, v: (B, S, H, D); ``mask``: None, a
    :class:`BandMask` (the kernels compute it from indices and skip the key
    tiles outside it) or a bool tensor broadcastable to (T, S), True =
    attend; ``seed``: an int32 for the in-kernel dropout
    (``prng.derive_seed``), needed when ``dropout_rate`` > 0. Returns
    (B, T, H, D) in q's dtype. Differentiable in q, k and v. Every query
    row must admit at least one key.

    On CUDA tensors it launches the hand-written kernels, which take
    float32 or bfloat16, contiguous tensors, any T and S, a head width of 1
    to 256 and B * H up to 65,535, and raises on anything else;
    ``flash_attention.launches``, ``flash_attention_dq.launches`` and
    ``flash_attention_dkv.launches`` count the launches, and their
    ``tc_launches`` the launches of the tensor-core variant
    (:func:`_kernel_variant`). On CPU tensors it runs the plain versions.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, mask, seed, dropout_rate)
    return flash_attention_forward(q, k, v, mask, seed, dropout_rate)[0]


for _counted in (flash_attention, flash_attention_dq, flash_attention_dkv):
    _counted.launches = 0
    _counted.tc_launches = 0
_entries = None    # the C entries, once load_library has bound them


def _signatures():
    """(restype, argtypes) of each C entry of ``csrc/flash_attention.cu``."""
    ptr, i32, u32, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_double)
    # Pointers (the mask's, which may be None, among them) and the stream
    # as c_void_p: without argtypes ctypes would cut each to 32 bits. After
    # the mask: B, T, S, H, D, the dtype code, the mask mode and window,
    # the seed and the dropout rate.
    tail = [ptr] + [i32] * 8 + [u32, f64, ptr]
    return {prefix + name: (i32, [ptr] * tensors + tail)
            for prefix in ("flash_attention_", "flash_attention_tc_")
            for name, tensors in (("fwd", 5), ("dq", 8), ("dkv", 8))}


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries by variant, ``{"scalar": (flash_attention_fwd,
    flash_attention_dq, flash_attention_dkv), "tc": (flash_attention_tc_fwd,
    flash_attention_tc_dq, flash_attention_tc_dkv)}``, bound once and kept
    for every later launch."""
    global _entries
    lib = build.load("flash_attention")
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _entries = {variant: tuple(getattr(lib, prefix + name)
                               for name in ("fwd", "dq", "dkv"))
                for variant, prefix in (("scalar", "flash_attention_"),
                                        ("tc", "flash_attention_tc_"))}
    return _entries
