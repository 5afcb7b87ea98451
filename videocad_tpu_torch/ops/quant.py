"""Int8 quantized matmul: dense layers with int8 x int8 -> int32 products.

Port of ``videocad_tpu/ops/quant.py`` (the "dynamic symmetric per-channel"
recipe):

  * activations x: one abs-max scale per row, over the contraction axis;
  * weights w: one abs-max scale per output column;
  * the int8 x int8 product accumulates in int32 (:func:`_q8_dot`), then is
    rescaled by the two scales, ``acc.float() * sa * sb`` in that order,
    and cast back to the compute dtype.

The backward (:class:`_Q8Matmul`) is ``"bf16"``, the straight-through
estimator: the gradients of the plain matmul in the compute dtype, from the
unquantized operands; or ``"int8"``: both backward products (dx = dy w^T
and dw = x^T dy) quantized too, with fresh scales over their own
contraction axes.

The JAX package computes the product outside any Pallas kernel (XLA lowers
its int8 ``dot_general``), so the port's product is the library's integer
matmul, ``torch._int_mm``, on every device. On the card it takes M > 16 and
K, N multiples of 8: :func:`_pad_operands` pads with zero rows and columns,
which leaves every integer sum exact, and the tests run that padding on the
CPU too. ``_q8_dot.launches`` counts its products on a CUDA tensor.

The integers equal the JAX package's compiled ones: XLA takes the scale's
``/ 127`` as a product with the float32 reciprocal, and that is what
:func:`_rowwise_scale` computes; the quantization itself divides, rounds
half to even and clips to +-127, as ``jnp.round`` and ``jnp.clip`` do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-12    # the scale's floor: keeps all-zero rows and columns finite
_QMAX = 127.0
_INV_QMAX = torch.tensor(1.0 / _QMAX, dtype=torch.float32).item()
MODES = ("none", "int8", "int8_bwd")


def check_quant(quant: str) -> None:
    if quant not in MODES:
        raise ValueError(f"unknown quant {quant!r} (expected one of {MODES})")


def _rowwise_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The symmetric abs-max scale along ``dim`` (kept), in float32."""
    amax = x.to(torch.float32).abs().amax(dim=dim, keepdim=True)
    return amax.clamp_min(_EPS) * _INV_QMAX


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale)
    return q.clamp(-_QMAX, _QMAX).to(torch.int8)


def _pad_operands(a: torch.Tensor, b: torch.Tensor):
    """``a`` (M, K), ``b`` (K, N) int8, padded with zeros to M > 16 and K,
    N multiples of 8, the shapes ``torch._int_mm`` takes on the card."""
    m, k = a.shape
    n = b.shape[1]
    pad_m = max(17 - m, 0)
    pad_k = -k % 8
    pad_n = -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    return a.contiguous(), b.contiguous()


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N), exact."""
    m, n = a.shape[0], b.shape[1]
    pa, pb = _pad_operands(a, b)
    acc = torch._int_mm(pa, pb)
    if a.device.type == "cuda":
        _q8_dot.launches += 1
    return acc[:m, :n]


def _q8_dot(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
            sb: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` (..., K) @ int8 ``b`` (K, N) with int32 accumulation,
    rescaled to float32 by ``sa`` (..., 1) and ``sb`` (1, N)."""
    lead = a.shape[:-1]
    acc = _int_matmul(a.reshape(-1, a.shape[-1]), b)
    acc = acc.reshape(lead + (b.shape[1],))
    return acc.to(torch.float32) * sa * sb


_q8_dot.launches = 0


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    sx = _rowwise_scale(x, -1)
    sw = _rowwise_scale(w, 0)
    return _q8_dot(_to_int8(x, sx), sx, _to_int8(w, sw), sw).to(x.dtype)


class _Q8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, backward):
        ctx.save_for_backward(x, w)
        ctx.backward = backward
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        k = x.shape[-1]
        xm = x.reshape(-1, k)
        dym = dy.reshape(-1, dy.shape[-1]).to(torch.float32)
        if ctx.backward == "int8":
            # dx = dy @ w^T, contracted over N.
            wt = w.t()
            sdy = _rowwise_scale(dym, -1)
            swt = _rowwise_scale(wt, 0)
            dxm = _q8_dot(_to_int8(dym, sdy), sdy, _to_int8(wt, swt), swt)
            # dw = x^T @ dy, contracted over the token axis M.
            xt = xm.t()
            sxt = _rowwise_scale(xt, -1)
            sdy_col = _rowwise_scale(dym, 0)
            dw = _q8_dot(_to_int8(xt, sxt), sxt, _to_int8(dym, sdy_col),
                         sdy_col)
        else:
            dym_c = dym.to(x.dtype)
            dxm = dym_c @ w.t().to(x.dtype)
            dw = xm.t() @ dym_c
        return (dxm.reshape(x.shape).to(x.dtype), dw.to(w.dtype), None)


def q8_matmul(x: torch.Tensor, w: torch.Tensor,
              backward: str = "bf16") -> torch.Tensor:
    """Quantized ``x @ w``: an int8 forward, a selectable backward.

    x: (..., K) activations in any compute dtype (the result has the same);
    w: (K, N) weights; backward: ``"bf16"`` (straight-through) or
    ``"int8"``.
    """
    if backward not in ("bf16", "int8"):
        raise ValueError(f"unknown q8 backward {backward!r}")
    return _Q8Matmul.apply(x, w, backward)


def quantized_dense(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], dtype: torch.dtype,
                    backward: str = "bf16") -> torch.Tensor:
    """A dense layer's body on the int8 product: ``x @ weight.T`` (torch's
    (out, in) layout) plus the bias, all in ``dtype``."""
    y = q8_matmul(x.to(dtype), weight.to(dtype).t(), backward)
    if bias is not None:
        y = y + bias.to(dtype)
    return y
