"""Fused pre-LN transformer sub-blocks: the ViT layer as two kernels.

Port of ``videocad_tpu/ops/fused_block.py``:

  ``attn_block``: y = x + drop(MHSA_drop(LN(x) Wq, LN(x) Wk, LN(x) Wv) Wo + bo)
  ``mlp_block``:  y = x + drop(drop(gelu(LN(x) W1 + b1)) W2 + b2)

Each is one hand-written kernel forward and one backward
(``csrc/fused_block.cu``). Autograd keeps only ``x``, the parameters and
the seed of a call: the backward recomputes everything from ``x`` and
redraws the dropout masks from the seed, so nothing of the width of q, k, v
or of the hidden layer lives between the two. That is what the setting is
for: it is the ViT's memory mode (``vit_attention_impl`` / ``vit_mlp_impl``
``"block"``).

The public functions keep the JAX functions' argument order and layouts:
``x`` (B, T, D); weights as (in, out) matrices, which for an ``nn.Linear``
style parameter stored (out, in) is the ``weight.t()`` view: the kernels
read it by strides, no transposed copy is made. Biases and LayerNorm
parameters are float32 vectors. The float32 weights are cast to ``x``'s
dtype once a call.

Rounding points (the Pallas bodies', ``fused_block.py:58-61`` there):
LayerNorm statistics in float32; h = LN(x) rounded to the I/O dtype before
each projection; every product accumulated in float32; q, k, v rounded
before the score product; softmax in float32; the dropped weights rounded
before the product with v; the merged heads, the hidden layer, the masked
output gradient, ds, dq, dk, dv and dz rounded before the products that
consume them. GELU is the exact erf form (the Pallas body approximates erf
to 1.5e-7 because its compiler has none). One product of the backward,
dWqkv = h^T dqkv, is left to ``torch.matmul`` on the emitted h and dqkv, as
the JAX wrapper leaves it to XLA; it returns the I/O dtype, as the backward
of every ``Dense`` of the port does.

Dropout: four sites (``ops/prng.py``: attention weights, attention branch,
hidden layer, MLP branch), each bit a function of (seed, site, frame, head,
row, column) that the kernels and the plain versions here both compute.

Dispatch: a CPU tensor runs the plain PyTorch versions
(:func:`attn_block_reference`, :func:`attn_block_backward_reference`,
:func:`mlp_block_reference`, :func:`mlp_block_backward_reference`); a CUDA
tensor launches the kernels or raises. There is no fallback from one to the
other. The kernels take float32 or bfloat16, T <= 64, D <= 512 and heads of
at most 64. Each sub-block has two kernel variants, which
:func:`_attn_variant` and :func:`_mlp_variant` pick from the dtype and the
shape alone: "tc" (bfloat16, D a multiple of 64, and heads of 64 for the
attention, F a multiple of 64 for the MLP: every product on the tensor
cores, the flagship ViT's shapes) and "tile" (float32, and every
other shape the kernels take); neither stands in for the other when a
launch fails.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from videocad_tpu_torch.kernels import build
from videocad_tpu_torch.ops.prng import (SITE_ATTN_RES, SITE_ATTN_W,
                                         SITE_MLP_HID, SITE_MLP_RES,
                                         block_site_bits, dropout_threshold,
                                         keep_mask, require_seed)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SEQ = 64        # a block of the attention kernels owns one frame
_MAX_DIM = 512       # a warp holds a row of x in registers
_MAX_HEAD_DIM = 64
_TC_HEAD_DIM = 64    # the head width of the attention's tc variant
_F32 = torch.float32
ATTN_VARIANTS = ("tc", "tile")
MLP_VARIANTS = ("tc", "tile")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype``, held in float32."""
    return x.to(dtype).to(_F32)


def _weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w.to(dtype).to(_F32)


def _layer_norm(flat, g, be, eps):
    """(N, D) f32 -> (LN output, xhat, rstd), the centred second moment."""
    mu = flat.mean(dim=-1, keepdim=True)
    xc = flat - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    return xhat * g + be, xhat, rstd


def _layer_norm_backward(dh, xhat, rstd, g):
    """dx of the LayerNorm for upstream dh, and (dscale, dbias)."""
    dg = (dh * xhat).sum(dim=0)
    dbe = dh.sum(dim=0)
    dxhat = dh * g
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dg, dbe


def keep_scale(seed, site, batch, heads, rows, cols, rate, device=None,
               frame_offset=0) -> Optional[torch.Tensor]:
    """The float32 multiplier of one dropout site, (batch, heads, rows,
    cols): 1 / (1 - rate) where the element is kept, 0 where it is dropped;
    None when ``rate`` is 0."""
    if rate == 0.0:
        return None
    bits = block_site_bits(seed, site, batch, heads, rows, cols,
                           device=device, frame_offset=frame_offset)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=_F32, device=bits.device)
    return torch.where(keep_mask(bits, rate), scale, torch.zeros_like(scale))


def _gelu(z):
    return 0.5 * z * (1.0 + torch.erf(z * (2.0 ** -0.5)))


def _dgelu(z):
    cdf = 0.5 * (1.0 + torch.erf(z * (2.0 ** -0.5)))
    pdf = torch.exp(-0.5 * z * z) * 0.3989422804014327   # 1 / sqrt(2 pi)
    return cdf + z * pdf


def _mlp_recompute(x, w1, b1, w2, b2, g, be, seed, rate, eps, frame_offset):
    b, t, d = x.shape
    f = w1.shape[1]
    dtype = x.dtype
    flat = x.to(_F32).reshape(b * t, d)
    drop_hid = keep_scale(seed, SITE_MLP_HID, b, 1, t, f, rate, x.device,
                          frame_offset)
    drop_res = keep_scale(seed, SITE_MLP_RES, b, 1, t, d, rate, x.device,
                          frame_offset)
    if rate > 0.0:
        drop_hid = drop_hid.reshape(b * t, f)
        drop_res = drop_res.reshape(b * t, d)
    w1c, w2c = _weight(w1, dtype), _weight(w2, dtype)
    h, xhat, rstd = _layer_norm(flat, g.to(_F32), be.to(_F32), eps)
    hb = _rounded(h, dtype)
    z = hb @ w1c + b1.to(_F32)
    a = _gelu(z)
    if rate > 0.0:
        a = a * drop_hid
    ab = _rounded(a, dtype)
    o = ab @ w2c + b2.to(_F32)
    if rate > 0.0:
        o = o * drop_res
    return flat, xhat, rstd, hb, z, ab, o, drop_hid, drop_res, w1c, w2c


def mlp_block_reference(x, w1, b1, w2, b2, g, be, seed,
                        dropout_rate: float = 0.0, eps: float = 1e-5,
                        frame_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the MLP forward kernel. ``frame_offset``:
    the absolute index of ``x``'s first frame in the dropout masks."""
    require_seed(seed, dropout_rate, "mlp_block")
    out = _mlp_recompute(x, w1, b1, w2, b2, g, be, seed, dropout_rate, eps,
                         frame_offset)
    flat, o = out[0], out[6]
    return (flat + o).reshape(x.shape).to(x.dtype)


def mlp_block_backward_reference(x, w1, b1, w2, b2, g, be, gy, seed,
                                 dropout_rate: float = 0.0,
                                 eps: float = 1e-5, frame_offset: int = 0):
    """Plain PyTorch version of the MLP backward kernel: (dx, dw1, db1, dw2,
    db2, dg, dbe) for the output gradient ``gy``, by the kernel's formulas
    and rounding points, not by autograd."""
    require_seed(seed, dropout_rate, "mlp_block")
    dtype = x.dtype
    rate = dropout_rate
    (flat, xhat, rstd, hb, z, ab, _, drop_hid, drop_res, w1c,
     w2c) = _mlp_recompute(x, w1, b1, w2, b2, g, be, seed, rate, eps,
                           frame_offset)
    gyf = gy.to(_F32).reshape(flat.shape)
    do = gyf * drop_res if rate > 0.0 else gyf
    dob = _rounded(do, dtype)
    dw2 = ab.t() @ dob
    db2 = do.sum(dim=0)
    dad = dob @ w2c.t()
    da = dad * drop_hid if rate > 0.0 else dad
    dz = da * _dgelu(z)
    dzb = _rounded(dz, dtype)
    dw1 = hb.t() @ dzb
    db1 = dz.sum(dim=0)
    dh = dzb @ w1c.t()
    dx_ln, dg, dbe = _layer_norm_backward(dh, xhat, rstd, g.to(_F32))
    dx = (gyf + dx_ln).reshape(x.shape).to(dtype)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype), dg.to(g.dtype), dbe.to(be.dtype))


def _heads(x2, b, t, num_heads):
    """(B*T, H*hd) -> (B, H, T, hd)."""
    return x2.reshape(b, t, num_heads, -1).permute(0, 2, 1, 3)


def _merge(xh, b, t):
    """(B, H, T, hd) -> (B*T, H*hd)."""
    return xh.permute(0, 2, 1, 3).reshape(b * t, -1)


def _attn_recompute(x, wq, wk, wv, g, be, seed, num_heads, rate, eps,
                    frame_offset):
    b, t, d = x.shape
    dtype = x.dtype
    inner = wq.shape[1]
    scale = 1.0 / math.sqrt(inner // num_heads)
    drop_w = keep_scale(seed, SITE_ATTN_W, b, num_heads, t, t, rate,
                        x.device, frame_offset)
    drop_res = keep_scale(seed, SITE_ATTN_RES, b, 1, t, d, rate, x.device,
                          frame_offset)
    if rate > 0.0:
        drop_res = drop_res.reshape(b * t, d)
    flat = x.to(_F32).reshape(b * t, d)
    h, xhat, rstd = _layer_norm(flat, g.to(_F32), be.to(_F32), eps)
    hb = _rounded(h, dtype)
    wqc, wkc, wvc = (_weight(w, dtype) for w in (wq, wk, wv))
    qh, kh, vh = (_heads(_rounded(hb @ w, dtype), b, t, num_heads)
                  for w in (wqc, wkc, wvc))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    weights = torch.softmax(scores, dim=-1)
    dropped = weights * drop_w if rate > 0.0 else weights
    droppedb = _rounded(dropped, dtype)
    a2 = _rounded(_merge(torch.matmul(droppedb, vh), b, t), dtype)
    return (flat, xhat, rstd, hb, qh, kh, vh, weights, droppedb, a2, drop_w,
            drop_res, scale, (wqc, wkc, wvc))


def attn_block_reference(x, wq, wk, wv, wo, bo, g, be, seed, num_heads: int,
                         dropout_rate: float = 0.0, eps: float = 1e-5,
                         frame_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the attention forward kernel."""
    require_seed(seed, dropout_rate, "attn_block")
    out = _attn_recompute(x, wq, wk, wv, g, be, seed, num_heads,
                          dropout_rate, eps, frame_offset)
    flat, a2, drop_res = out[0], out[9], out[11]
    o = a2 @ _weight(wo, x.dtype) + bo.to(_F32)
    if dropout_rate > 0.0:
        o = o * drop_res
    return (flat + o).reshape(x.shape).to(x.dtype)


def _qkv_weight_grads(h, dqkv, inner):
    """dWq, dWk, dWv (D, inner each, float32) from the emitted h (N, D) and
    dqkv (N, 3 * inner): the one product left to ``torch.matmul``."""
    # (3 * inner, D), so that each gradient's (out, in) transpose, which is
    # what a parameter stored (out, in) receives, is contiguous.
    dwqkv = torch.matmul(dqkv.t(), h).to(_F32)
    return (dwqkv[:inner].t(), dwqkv[inner:2 * inner].t(),
            dwqkv[2 * inner:].t())


def attn_block_backward_reference(x, wq, wk, wv, wo, bo, g, be, gy, seed,
                                  num_heads: int, dropout_rate: float = 0.0,
                                  eps: float = 1e-5, frame_offset: int = 0):
    """Plain PyTorch version of the attention backward kernel: (dx, dwq,
    dwk, dwv, dwo, dbo, dg, dbe), by the kernel's formulas and rounding
    points."""
    require_seed(seed, dropout_rate, "attn_block")
    b, t, d = x.shape
    dtype = x.dtype
    rate = dropout_rate
    inner = wq.shape[1]
    (flat, xhat, rstd, hb, qh, kh, vh, weights, droppedb, a2, drop_w,
     drop_res, scale, (wqc, wkc, wvc)) = _attn_recompute(
        x, wq, wk, wv, g, be, seed, num_heads, rate, eps, frame_offset)
    gyf = gy.to(_F32).reshape(flat.shape)
    do = gyf * drop_res if rate > 0.0 else gyf
    dob = _rounded(do, dtype)
    dwo = a2.t() @ dob
    dbo = do.sum(dim=0)
    dab = _heads(_rounded(dob @ _weight(wo, dtype).t(), dtype), b, t,
                 num_heads)
    ddropped = torch.matmul(dab, vh.transpose(-1, -2))
    dw = ddropped * drop_w if rate > 0.0 else ddropped
    ds = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    ds = _rounded(ds * scale, dtype)
    dq2, dk2, dv2 = (_rounded(_merge(y, b, t), dtype) for y in (
        torch.matmul(ds, kh), torch.matmul(ds.transpose(-1, -2), qh),
        torch.matmul(droppedb.transpose(-1, -2), dab)))
    dh = dq2 @ wqc.t() + dk2 @ wkc.t() + dv2 @ wvc.t()
    dx_ln, dg, dbe = _layer_norm_backward(dh, xhat, rstd, g.to(_F32))
    dx = (gyf + dx_ln).reshape(x.shape).to(dtype)
    dwq, dwk, dwv = _qkv_weight_grads(
        hb.to(dtype), torch.cat([dq2, dk2, dv2], dim=1).to(dtype), inner)
    return (dx, dwq.to(wq.dtype), dwk.to(wk.dtype), dwv.to(wv.dtype),
            dwo.to(wo.dtype), dbo.to(bo.dtype), dg.to(g.dtype),
            dbe.to(be.dtype))


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------


def _check_vectors(op, width, **vectors):
    for name, v in vectors.items():
        if v.dim() != 1 or v.shape[0] != width:
            raise ValueError(f"{op}: {name} must be ({width},), got "
                             f"{tuple(v.shape)}")


def _check_mlp(x, w1, b1, w2, b2, g, be):
    if x.dim() != 3:
        raise ValueError(f"mlp_block takes x (B, T, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    if w1.dim() != 2 or w2.dim() != 2 or w1.shape[0] != d or (
            w2.shape != (w1.shape[1], d)):
        raise ValueError(f"mlp_block takes w1 (D, F) and w2 (F, D), got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} at D={d}")
    _check_vectors("mlp_block", w1.shape[1], b1=b1)
    _check_vectors("mlp_block", d, b2=b2, g=g, be=be)
    _check_one_device("mlp_block", x, w1, b1, w2, b2, g, be)


def _check_attn(x, wq, wk, wv, wo, bo, g, be, num_heads):
    if x.dim() != 3:
        raise ValueError(f"attn_block takes x (B, T, D), got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    inner = wq.shape[-1]
    if any(w.dim() != 2 or tuple(w.shape) != (d, inner)
           for w in (wq, wk, wv)) or tuple(wo.shape) != (inner, d):
        raise ValueError(
            f"attn_block takes wq, wk, wv (D, H*hd) and wo (H*hd, D), got "
            f"{[tuple(w.shape) for w in (wq, wk, wv, wo)]} at D={d}")
    if inner % num_heads:
        raise ValueError(f"width {inner} is not a multiple of {num_heads} "
                         "heads")
    _check_vectors("attn_block", d, bo=bo, g=g, be=be)
    _check_one_device("attn_block", x, wq, wk, wv, wo, bo, g, be)


def _check_one_device(op, x, *others):
    if any(o.device != x.device for o in others):
        raise ValueError(f"{op} takes x and every parameter on one device")


def _check_rate(dropout_rate):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} is not in [0, 1)")


def _check_kernel_inputs(op, x, *same_shape):
    """What the kernels take: float32 or bfloat16, contiguous x (and gy),
    D <= 512."""
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on CPU or CUDA, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not all(t.is_contiguous() for t in (x,) + same_shape):
        raise ValueError(f"{op} kernel takes a contiguous x")
    if x.shape[-1] > _MAX_DIM:
        raise ValueError(f"{op} kernel takes D <= {_MAX_DIM}, got "
                         f"D={x.shape[-1]}")


def _param(v: torch.Tensor) -> torch.Tensor:
    """A bias or LayerNorm vector as the kernels read it: float32,
    contiguous."""
    return v.detach().to(_F32).contiguous()


def _dropout_args(seed, dropout_rate) -> Tuple[int, int, float]:
    """(seed, u32 threshold, 1 / (1 - rate)) as the C entries take them."""
    if dropout_rate == 0.0:
        return 0, 0, 1.0
    return (seed & 0xFFFFFFFF, dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


def _grad_like(w: torch.Tensor) -> torch.Tensor:
    """An empty float32 gradient with ``w``'s shape and, where ``w`` is a
    dense view (``weight.t()``), its strides, so that the gradient of the
    stored parameter comes out contiguous."""
    return torch.empty_like(w, dtype=_F32)


def _raise_on(err: int, op: str) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")


def _attn_variant(dtype: torch.dtype, t: int, d: int, head_dim: int) -> str:
    """The attention kernels' variant for a CUDA call: "tc" for bfloat16
    with heads of 64, D a multiple of 64 up to 512 and 1 <= T <= 64, "tile"
    for everything else the kernels take (float32: the tensor cores would
    round it to TF32)."""
    if (dtype == torch.bfloat16 and head_dim == _TC_HEAD_DIM
            and d % 64 == 0 and 64 <= d <= _MAX_DIM and 1 <= t <= _MAX_SEQ):
        return "tc"
    return "tile"


def _mlp_variant(dtype: torch.dtype, d: int, f: int) -> str:
    """The MLP kernels' variant for a CUDA call: "tc" for bfloat16 with D
    and F multiples of 64, D up to 512, "tile" for everything else the
    kernels take (float32: the tensor cores would round it to TF32)."""
    if (dtype == torch.bfloat16 and d % 64 == 0 and f % 64 == 0
            and 64 <= d <= _MAX_DIM and f >= 64):
        return "tc"
    return "tile"


_sm_counts: dict = {}


def _slots(tiles: int, device: torch.device) -> int:
    """Blocks of a tc kernel that runs two an SM on a persistent grid and
    walks ``tiles`` tiles (frames or 64-row tiles)."""
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return min(tiles, 2 * _sm_counts[device.index])


def _mlp_forward(x, w1, b1, w2, b2, g, be, seed, rate, eps, variant=None):
    """The forward of :func:`mlp_block`; ``variant`` (of
    :data:`MLP_VARIANTS`) overrides :func:`_mlp_variant` on a CUDA
    tensor."""
    if x.device.type == "cpu":
        return mlp_block_reference(x, w1, b1, w2, b2, g, be, seed, rate, eps)
    _check_kernel_inputs("mlp_block", x)
    b, t, d = x.shape
    f = w1.shape[1]
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    variant = variant or _mlp_variant(x.dtype, d, f)
    entries = _entries or load_library()
    b1, b2, g, be = (_param(v) for v in (b1, b2, g, be))
    rows = b * t
    tail = (eps, _DTYPE_CODES[x.dtype], *_dropout_args(seed, rate))
    if variant == "tc":
        w1c, w2c = _stored(x, w1), _stored(x, w2)
        # Each block has its 64 rows of the hidden layer, which stay in L2.
        slots = _slots(-(-rows // 64), x.device)
        abuf = torch.empty((slots * 64, f), dtype=x.dtype, device=x.device)
        err = build.launch(
            entries["mlp_block_tc_fwd"], x.device.index, x.data_ptr(),
            w1c.data_ptr(), b1.data_ptr(), w2c.data_ptr(), b2.data_ptr(),
            g.data_ptr(), be.data_ptr(), abuf.data_ptr(), y.data_ptr(), rows,
            t, d, f, slots, *tail)
    else:
        w1c, w2c = w1.detach().to(x.dtype), w2.detach().to(x.dtype)
        hbuf = torch.empty_like(x)    # h = LN(x): each block reads its own
        err = build.launch(
            entries["mlp_block_fwd"], x.device.index, x.data_ptr(),
            w1c.data_ptr(), *w1c.stride(), b1.data_ptr(), w2c.data_ptr(),
            *w2c.stride(), b2.data_ptr(), g.data_ptr(), be.data_ptr(),
            hbuf.data_ptr(), y.data_ptr(), rows, t, d, f, *tail)
    del w1c, w2c    # held until the launch was queued
    _raise_on(err, f"mlp_block {variant}")
    mlp_block.launches += 1
    mlp_block.tc_launches += variant == "tc"
    return y


def mlp_block_backward(x, w1, b1, w2, b2, g, be, gy, seed,
                       dropout_rate: float = 0.0, eps: float = 1e-5):
    """(dx, dw1, db1, dw2, db2, dg, dbe) of :func:`mlp_block` for the output
    gradient ``gy``: on a CUDA tensor the backward kernel, its partial sums
    and the two weight-gradient products, all hand-written
    (``mlp_block_backward.launches`` counts the calls, ``.tc_launches``
    those of the tc variant); on a CPU tensor
    :func:`mlp_block_backward_reference`."""
    _check_mlp(x, w1, b1, w2, b2, g, be)
    require_seed(seed, dropout_rate, "mlp_block")
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError("mlp_block_backward takes gy like x")
    if x.device.type == "cpu":
        return mlp_block_backward_reference(x, w1, b1, w2, b2, g, be, gy,
                                            seed, dropout_rate, eps)
    return _mlp_backward(x, w1, b1, w2, b2, g, be, gy, seed, dropout_rate,
                         eps)


def _mlp_backward(x, w1, b1, w2, b2, g, be, gy, seed, dropout_rate, eps,
                  variant=None):
    """:func:`mlp_block_backward` on a CUDA tensor; ``variant`` as for
    :func:`_mlp_forward`."""
    gy = gy.contiguous()
    _check_kernel_inputs("mlp_block", x, gy)
    b, t, d = x.shape
    f = w1.shape[1]
    variant = variant or _mlp_variant(x.dtype, d, f)
    rows = b * t
    dx = torch.empty_like(x)
    dw1, dw2 = _grad_like(w1), _grad_like(w2)
    # [db2 | dg | dbe | db1]: the kernels' sums write every entry.
    small = torch.empty(3 * d + f, dtype=_F32, device=x.device)
    if rows > 0:
        entries = _entries or load_library()
        b1c, gc, bec = (_param(v) for v in (b1, g, be))
        new = lambda width: torch.empty((rows, width), dtype=x.dtype,  # noqa: E731
                                        device=x.device)
        hbuf, dobbuf, abbuf, dzbuf = new(d), new(d), new(f), new(f)
        work = torch.empty(entries["mlp_block_bwd_workspace"](rows, d, f),
                           dtype=_F32, device=x.device)
        inputs = (gc.data_ptr(), bec.data_ptr(), gy.data_ptr(),
                  hbuf.data_ptr(), dobbuf.data_ptr(), abbuf.data_ptr(),
                  dzbuf.data_ptr())
        outputs = (dx.data_ptr(), dw1.data_ptr(), *dw1.stride(),
                   dw2.data_ptr(), *dw2.stride(), small.data_ptr(),
                   work.data_ptr(), rows, t, d, f)
        tail = (eps, _DTYPE_CODES[x.dtype],
                *_dropout_args(seed, dropout_rate))
        if variant == "tc":
            w1c, w2c = _stored(x, w1), _stored(x, w2)
            # Each block has its 64 rows of dh (float32), which stay in L2.
            slots = _slots(-(-rows // 64), x.device)
            dhbuf = torch.empty((slots * 64, d), dtype=_F32, device=x.device)
            err = build.launch(
                entries["mlp_block_tc_bwd"], x.device.index, x.data_ptr(),
                w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), *inputs,
                dhbuf.data_ptr(), *outputs, slots, *tail)
        else:
            w1c, w2c = w1.detach().to(x.dtype), w2.detach().to(x.dtype)
            err = build.launch(
                entries["mlp_block_bwd"], x.device.index, x.data_ptr(),
                w1c.data_ptr(), *w1c.stride(), b1c.data_ptr(),
                w2c.data_ptr(), *w2c.stride(), *inputs, *outputs, *tail)
        del w1c, w2c    # held until the launch was queued
        _raise_on(err, f"mlp_block_backward {variant}")
        mlp_block_backward.launches += 1
        mlp_block_backward.tc_launches += variant == "tc"
    else:
        dw1.zero_()
        dw2.zero_()
        small.zero_()
    db2, dg, dbe, db1 = small.split([d, d, d, f])
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype), dg.to(g.dtype), dbe.to(be.dtype))


def _attn_kernel_shapes(x, wq, num_heads):
    b, t, d = x.shape
    inner = wq.shape[1]
    head_dim = inner // num_heads
    if t > _MAX_SEQ or head_dim > _MAX_HEAD_DIM:
        raise ValueError(
            f"attn_block kernel takes T <= {_MAX_SEQ} and heads of at most "
            f"{_MAX_HEAD_DIM}, got T={t}, head width {head_dim}")
    return b, t, d, inner, head_dim


def _weight_args(x, *weights):
    """The four weights cast to x's dtype (kept alive by the caller), their
    pointers and their eight strides as C arrays."""
    cast = [w.detach().to(x.dtype) for w in weights]
    pointers = (ctypes.c_void_p * len(cast))(*(w.data_ptr() for w in cast))
    strides = (ctypes.c_longlong * (2 * len(cast)))(
        *(s for w in cast for s in w.stride()))
    return cast, pointers, strides


def _stored(x, w):
    """A weight as the tc kernels read it: cast to x's dtype and contiguous
    as an (out, in) matrix is stored (for the model's ``weight.t()`` views
    no copy)."""
    return w.detach().to(x.dtype).t().contiguous()


def _stored_weights(x, *weights):
    """The weights as the tc kernels read them (:func:`_stored`), kept alive
    by the caller, and their pointers as a C array."""
    stored = [_stored(x, w) for w in weights]
    return stored, (ctypes.c_void_p * len(stored))(
        *(w.data_ptr() for w in stored))


def _attn_forward(x, wq, wk, wv, wo, bo, g, be, seed, num_heads, rate, eps,
                  variant=None):
    """The forward of :func:`attn_block`; ``variant`` (of
    :data:`ATTN_VARIANTS`) overrides :func:`_attn_variant` on a CUDA
    tensor."""
    if x.device.type == "cpu":
        return attn_block_reference(x, wq, wk, wv, wo, bo, g, be, seed,
                                    num_heads, rate, eps)
    _check_kernel_inputs("attn_block", x)
    b, t, d, inner, head_dim = _attn_kernel_shapes(x, wq, num_heads)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    variant = variant or _attn_variant(x.dtype, t, d, head_dim)
    entries = _entries or load_library()
    bo, g, be = (_param(v) for v in (bo, g, be))
    tail = (eps, _DTYPE_CODES[x.dtype], *_dropout_args(seed, rate))
    hbuf = torch.empty_like(x)    # h = LN(x): each block reads back its own
    if variant == "tc":
        cast, pointers = _stored_weights(x, wq, wk, wv, wo)
        # Two blocks an SM walk the frames; each has its 64 rows of the
        # merged heads, which stay in L2, as h does.
        slots = _slots(b, x.device)
        abuf = torch.empty((slots * _MAX_SEQ, inner), dtype=x.dtype,
                           device=x.device)
        err = build.launch(
            entries["attn_block_tc_fwd"], x.device.index, x.data_ptr(),
            pointers, bo.data_ptr(), g.data_ptr(), be.data_ptr(),
            hbuf.data_ptr(), abuf.data_ptr(), y.data_ptr(), b, t, d,
            num_heads, slots, *tail)
    else:
        cast, pointers, strides = _weight_args(x, wq, wk, wv, wo)
        err = build.launch(
            entries["attn_block_fwd"], x.device.index, x.data_ptr(),
            pointers, strides, bo.data_ptr(), g.data_ptr(), be.data_ptr(),
            hbuf.data_ptr(), y.data_ptr(), b, t, d, num_heads, head_dim,
            1.0 / math.sqrt(head_dim), *tail)
    del cast    # held until the launch was queued
    _raise_on(err, f"attn_block {variant}")
    attn_block.launches += 1
    attn_block.tc_launches += variant == "tc"
    return y


def attn_block_backward(x, wq, wk, wv, wo, bo, g, be, gy, seed,
                        num_heads: int, dropout_rate: float = 0.0,
                        eps: float = 1e-5):
    """(dx, dwq, dwk, dwv, dwo, dbo, dg, dbe) of :func:`attn_block` for the
    output gradient ``gy``: on a CUDA tensor the backward kernel, its
    partial sums and the dWo product, all hand-written, and one
    ``torch.matmul`` for dWq, dWk, dWv on the emitted h and dqkv
    (``attn_block_backward.launches`` counts the calls, ``.tc_launches``
    those of the tc variant); on a CPU tensor
    :func:`attn_block_backward_reference`."""
    _check_attn(x, wq, wk, wv, wo, bo, g, be, num_heads)
    require_seed(seed, dropout_rate, "attn_block")
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError("attn_block_backward takes gy like x")
    if x.device.type == "cpu":
        return attn_block_backward_reference(x, wq, wk, wv, wo, bo, g, be,
                                             gy, seed, num_heads,
                                             dropout_rate, eps)
    return _attn_backward(x, wq, wk, wv, wo, bo, g, be, gy, seed, num_heads,
                          dropout_rate, eps)


def _attn_backward(x, wq, wk, wv, wo, bo, g, be, gy, seed, num_heads,
                   dropout_rate, eps, variant=None):
    """:func:`attn_block_backward` on a CUDA tensor; ``variant`` as for
    :func:`_attn_forward`."""
    gy = gy.contiguous()
    _check_kernel_inputs("attn_block", x, gy)
    b, t, d, inner, head_dim = _attn_kernel_shapes(x, wq, num_heads)
    variant = variant or _attn_variant(x.dtype, t, d, head_dim)
    rows = b * t
    dx = torch.empty_like(x)
    dwo = _grad_like(wo)
    # [dbo | dg | dbe]: the kernels write every entry.
    small = torch.empty(3 * d, dtype=_F32, device=x.device)
    new = lambda width: torch.empty((rows, width), dtype=x.dtype,  # noqa: E731
                                    device=x.device)
    hbuf, dqkv = new(d), new(3 * inner)
    if rows > 0:
        entries = _entries or load_library()
        gc, bec = _param(g), _param(be)
        dobbuf, a2buf = new(d), new(inner)
        work = torch.empty(
            entries["attn_block_bwd_workspace"](b, t, d, inner), dtype=_F32,
            device=x.device)
        buffers = (gc.data_ptr(), bec.data_ptr(), gy.data_ptr(),
                   hbuf.data_ptr(), dobbuf.data_ptr(), a2buf.data_ptr(),
                   dqkv.data_ptr(), dx.data_ptr(), dwo.data_ptr(),
                   *dwo.stride(), small.data_ptr(), work.data_ptr(), b, t, d,
                   num_heads)
        tail = (eps, _DTYPE_CODES[x.dtype],
                *_dropout_args(seed, dropout_rate))
        if variant == "tc":
            cast, pointers = _stored_weights(x, wq, wk, wv, wo)
            err = build.launch(entries["attn_block_tc_bwd"], x.device.index,
                               x.data_ptr(), pointers, *buffers, *tail)
        else:
            cast, pointers, strides = _weight_args(x, wq, wk, wv, wo)
            err = build.launch(entries["attn_block_bwd"], x.device.index,
                               x.data_ptr(), pointers, strides, *buffers,
                               head_dim, 1.0 / math.sqrt(head_dim), *tail)
        del cast    # held until the launch was queued
        _raise_on(err, f"attn_block_backward {variant}")
        attn_block_backward.launches += 1
        attn_block_backward.tc_launches += variant == "tc"
    else:
        dwo.zero_()
        small.zero_()
    dwq, dwk, dwv = _qkv_weight_grads(hbuf, dqkv, inner)
    dbo, dg, dbe = small.split([d, d, d])
    return (dx, dwq.to(wq.dtype), dwk.to(wk.dtype), dwv.to(wv.dtype),
            dwo.to(wo.dtype), dbo.to(bo.dtype), dg.to(g.dtype),
            dbe.to(be.dtype))


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _MlpBlock(torch.autograd.Function):
    """The MLP kernels under autograd: x, the parameters and the seed are
    all that is kept for the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g, be, seed, rate, eps):
        ctx.save_for_backward(x, w1, b1, w2, b2, g, be)
        ctx.args = (seed, rate, eps)
        return _mlp_forward(x, w1, b1, w2, b2, g, be, seed, rate, eps)

    @staticmethod
    def backward(ctx, gy):
        grads = mlp_block_backward(*ctx.saved_tensors, gy, *ctx.args)
        return grads + (None, None, None)


class _AttnBlock(torch.autograd.Function):
    """The attention kernels under autograd; as :class:`_MlpBlock`."""

    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, bo, g, be, seed, num_heads, rate,
                eps):
        ctx.save_for_backward(x, wq, wk, wv, wo, bo, g, be)
        ctx.args = (seed, num_heads, rate, eps)
        return _attn_forward(x, wq, wk, wv, wo, bo, g, be, seed, num_heads,
                             rate, eps)

    @staticmethod
    def backward(ctx, gy):
        grads = attn_block_backward(*ctx.saved_tensors, gy, *ctx.args)
        return grads + (None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mlp_block(x, w1, b1, w2, b2, g, be, seed, dropout_rate: float = 0.0,
              eps: float = 1e-5) -> torch.Tensor:
    """y = x + drop(drop(gelu(LN(x) @ w1 + b1)) @ w2 + b2).

    x: (B, T, D); w1 (D, F); w2 (F, D) (for a parameter stored (out, in) pass
    ``weight.t()``); b1, b2, g, be float32 vectors; ``seed``: an int32 for
    the in-kernel dropout (``prng.derive_seed``), ignored (may be None) when
    ``dropout_rate`` is 0. Differentiable in x and every parameter.

    On a CUDA tensor it launches the hand-written kernels and raises on what
    they do not take (another dtype than float32 or bfloat16, a
    non-contiguous x, D > 512); ``mlp_block.launches`` and
    ``mlp_block_backward.launches`` count the launches, their
    ``.tc_launches`` those of the tensor-core variant (:func:`_mlp_variant`).
    On a CPU tensor it runs the plain versions.
    """
    _check_mlp(x, w1, b1, w2, b2, g, be)
    require_seed(seed, dropout_rate, "mlp_block")
    _check_rate(dropout_rate)
    if _needs_grad(x, w1, b1, w2, b2, g, be):
        return _MlpBlock.apply(x, w1, b1, w2, b2, g, be, seed, dropout_rate,
                               eps)
    return _mlp_forward(x, w1, b1, w2, b2, g, be, seed, dropout_rate, eps)


def attn_block(x, wq, wk, wv, wo, bo, g, be, seed, num_heads: int,
               dropout_rate: float = 0.0, eps: float = 1e-5) -> torch.Tensor:
    """y = x + drop(MHSA_drop(LN(x) @ wq, LN(x) @ wk, LN(x) @ wv) @ wo + bo).

    x: (B, T, D); wq, wk, wv (D, H*hd), no bias; wo (H*hd, D); bo, g, be
    float32 vectors; ``seed`` as for :func:`mlp_block`. Differentiable in x
    and every parameter.

    On a CUDA tensor it launches the hand-written kernels and raises on what
    they do not take (as :func:`mlp_block`, and T > 64 or a head wider than
    64); ``attn_block.launches`` and ``attn_block_backward.launches`` count
    the launches, their ``.tc_launches`` those of the tensor-core variant
    (:func:`_attn_variant`). On a CPU tensor it runs the plain versions.
    """
    _check_attn(x, wq, wk, wv, wo, bo, g, be, num_heads)
    require_seed(seed, dropout_rate, "attn_block")
    _check_rate(dropout_rate)
    if _needs_grad(x, wq, wk, wv, wo, bo, g, be):
        return _AttnBlock.apply(x, wq, wk, wv, wo, bo, g, be, seed,
                                num_heads, dropout_rate, eps)
    return _attn_forward(x, wq, wk, wv, wo, bo, g, be, seed, num_heads,
                         dropout_rate, eps)


attn_block.launches = 0
attn_block.tc_launches = 0
attn_block_backward.launches = 0
attn_block_backward.tc_launches = 0
mlp_block.launches = 0
mlp_block.tc_launches = 0
mlp_block_backward.launches = 0
mlp_block_backward.tc_launches = 0
_entries = None    # the C entries, once load_library has bound them


def _signatures():
    """(restype, argtypes) of each C entry of ``csrc/fused_block.cu``."""
    ptr, i64, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_float, ctypes.c_uint)
    # Pointers and the stream as c_void_p: without argtypes ctypes would
    # pass each Python int as a 32-bit int and cut the pointer.
    drop_tail = [f32, i32, u32, u32, f32, ptr]   # eps, dtype, dropout, stream
    weight = [ptr, i64, i64]
    return {
        "mlp_block_fwd": (i32, [ptr] + weight + [ptr] + weight + [ptr] * 5
                          + [i64, i32, i32, i32] + drop_tail),
        "mlp_block_bwd": (i32, [ptr] + weight + [ptr] + weight + [ptr] * 8
                          + weight + weight + [ptr, ptr]
                          + [i64, i32, i32, i32] + drop_tail),
        "attn_block_fwd": (i32, [ptr] * 8 + [i32] * 5 + [f32] + drop_tail),
        "attn_block_bwd": (i32, [ptr] * 12 + [i64, i64, ptr, ptr]
                           + [i32] * 5 + [f32] + drop_tail),
        "attn_block_tc_fwd": (i32, [ptr] * 8 + [i32] * 5 + drop_tail),
        "attn_block_tc_bwd": (i32, [ptr] * 11 + [i64, i64, ptr, ptr]
                              + [i32] * 4 + drop_tail),
        "mlp_block_tc_fwd": (i32, [ptr] * 9 + [i64] + [i32] * 4
                             + drop_tail),
        "mlp_block_tc_bwd": (i32, [ptr] * 13 + weight + weight + [ptr, ptr]
                             + [i64] + [i32] * 4 + drop_tail),
        "mlp_block_bwd_workspace": (i64, [i64, i32, i32]),
        "attn_block_bwd_workspace": (i64, [i64, i32, i32, i32]),
    }


def load_library():
    """Build (at first use) and load the kernels' library; returns its C
    entries by name, bound once and kept for every later launch."""
    global _entries
    lib = build.load("fused_block")
    entries = {}
    for name, (restype, argtypes) in _signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        entries[name] = fn
    _entries = entries
    return _entries
