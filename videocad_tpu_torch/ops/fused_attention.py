"""Fused multi-head self-attention for short sequences (the ViT hot path).

Port of ``videocad_tpu/ops/fused_attention.py:mhsa_short``, forward only.
q, k and v stay in the (B, T, H*D) layout the projections produce; the
head split happens inside the kernel (``csrc/mhsa_short.cu``), so no
transpose runs around it. The math: scores = q k^T with f32 accumulation,
times 1/sqrt(D); a row softmax in f32; the weights cast to the I/O dtype;
P V with f32 accumulation; the output in the I/O dtype.

Dispatch: a CPU tensor runs :func:`mhsa_short_reference`, the plain
PyTorch version beside the kernel; a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SEQ = 64       # the kernel pads T to 64 (csrc/mhsa_short.cu)
_MAX_HEAD_DIM = 64


def mhsa_short_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, T, H*D) -> (B, T, H*D)."""
    b, t, hd = q.shape
    d = hd // num_heads
    split = lambda x: x.reshape(b, t, num_heads, d).permute(0, 2, 1, 3)  # noqa: E731
    qh, kh, vh = (split(x).to(torch.float32) for x in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    weights = torch.softmax(scores, dim=-1).to(q.dtype).to(torch.float32)
    out = torch.matmul(weights, vh).to(q.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, t, hd)


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


def mhsa_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               num_heads: int, dropout_rate: float = 0.0) -> torch.Tensor:
    """Fused bidirectional MHSA: q, k, v (B, T, H*D) -> (B, T, H*D).

    On a CUDA tensor it launches the hand-written kernel, which takes
    float32 or bfloat16, contiguous inputs, T <= 64 and D <= 64, and raises
    on anything else; ``mhsa_short.launches`` counts those launches. On a
    CPU tensor it runs :func:`mhsa_short_reference`.
    """
    _check(q, k, v, num_heads)
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "mhsa_short dropout runs in the training kernel, not ported "
            "yet (ROADMAP K1-bwd)")
    if q.device.type == "cpu":
        return mhsa_short_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mhsa_short runs on CPU or CUDA, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "mhsa_short has no backward kernel yet (ROADMAP K1-bwd); call "
            "it under torch.no_grad()")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"mhsa_short kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mhsa_short kernel takes contiguous q, k, v")
    b, t, hd = q.shape
    head_dim = hd // num_heads
    if t > _MAX_SEQ or head_dim > _MAX_HEAD_DIM:
        raise ValueError(f"mhsa_short kernel takes T <= {_MAX_SEQ} and "
                         f"D <= {_MAX_HEAD_DIM}, got T={t}, D={head_dim}")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    fwd = _kernel_entry or load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            num_heads, head_dim, 1.0 / math.sqrt(head_dim),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mhsa_short kernel launch failed: CUDA error "
                           f"{err}")
    mhsa_short.launches += 1
    return out


mhsa_short.launches = 0
_kernel_entry = None    # the C entry, once load_library has bound it


def load_library():
    """Build (at first use) and load the kernel's library; returns its C
    entry ``mhsa_short_fwd``, bound once and kept for every later launch."""
    global _kernel_entry
    from videocad_tpu_torch.kernels import build

    fwd = build.load("mhsa_short").mhsa_short_fwd
    # Pointers and the stream as c_void_p: without argtypes ctypes would
    # pass each Python int as a 32-bit int and cut the pointer.
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    _kernel_entry = fwd
    return fwd
