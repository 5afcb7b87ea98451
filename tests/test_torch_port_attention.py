"""The PyTorch port's flash attention against the JAX package's.

Inputs are made with numpy from a seed and fed to both. The JAX side runs
its Pallas kernels in interpret mode on the CPU with
``precision=HIGHEST``, as ``tests/test_attention.py`` runs them; the port
runs the plain versions that stand beside its CUDA kernels (CPU tensors),
forward and backward. Dropout cannot be compared (the TPU generator's
stream does not exist off the TPU): it is held by its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocad_tpu.models import layers as jax_layers
from videocad_tpu.ops.attention import flash_attention as jax_flash
from videocad_tpu_torch.models import layers as port_layers
from videocad_tpu_torch.ops import attention as fl
from videocad_tpu_torch.ops import prng

HIGHEST = jax.lax.Precision.HIGHEST


def _inputs(b, t, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in [(b, t, h, d), (b, s, h, d), (b, s, h, d),
                          (b, t, h, d)]]


def _mask(kind, t, s, seed=0):
    """(the port's mask argument, the same mask as a numpy bool array)."""
    if kind == "none":
        return None, None
    if kind in ("causal", "band"):
        band = fl.BandMask(t, s, 3 if kind == "band" else None)
        return band, band.tensor().numpy()
    rng = np.random.default_rng(seed)
    mask = rng.random((t, s)) < 0.4
    mask[np.arange(t), np.minimum(np.arange(t), s - 1)] = True
    return torch.from_numpy(mask), mask


def _jax_forward(q, k, v, mask):
    mask = None if mask is None else jnp.asarray(mask)
    return jax_flash(q, k, v, mask, None, 0.0, 128, 128, HIGHEST)


# T and S that are no multiple of 8, T != S, more keys than one block.
CASES = [
    ("none", 2, 13, 13, 2, 16),
    ("none", 1, 9, 21, 3, 8),
    ("causal", 2, 13, 13, 2, 16),
    ("causal", 1, 37, 37, 2, 32),
    ("band", 2, 13, 13, 2, 16),
    ("band", 2, 47, 47, 1, 24),
    ("random", 2, 13, 21, 2, 16),
    ("random", 1, 30, 11, 2, 8),
    ("random", 1, 20, 150, 1, 16),
]


@pytest.mark.parametrize("kind,b,t,s,h,d", CASES)
def test_flash_attention_forward_matches_jax_at_float32(kind, b, t, s, h, d):
    """1e-5: both sides sum in float32, in another order."""
    q, k, v, _ = _inputs(b, t, s, h, d, seed=t * 100 + s)
    mask, mask_np = _mask(kind, t, s)
    want = _jax_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask_np)
    with torch.no_grad():
        got = fl.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 mask)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kind,b,t,s,h,d", CASES[::2])
def test_flash_attention_forward_matches_jax_at_bfloat16(kind, b, t, s, h,
                                                         d):
    """bf16 in and out, float32 math inside on both sides: the outputs
    agree to one unit in the last place of bf16 (the one rounding of the
    output can fall to the other side)."""
    arrays = _inputs(b, t, s, h, d, seed=t * 100 + s + 1)
    mask, mask_np = _mask(kind, t, s)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays[:3])
    want = _jax_forward(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                          for x in (q, k, v)), mask_np)
    with torch.no_grad():
        got = fl.flash_attention(q, k, v, mask)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


@pytest.mark.parametrize("kind,b,t,s,h,d", [
    ("none", 1, 9, 21, 2, 8),
    ("causal", 2, 13, 13, 2, 16),
    ("band", 2, 19, 19, 2, 16),
    ("random", 2, 13, 21, 2, 16),
])
def test_flash_attention_gradients_match_jax(kind, b, t, s, h, d):
    """dq, dk, dv against jax.grad through the JAX function (its Pallas
    backward kernels, interpreted), float32, 2e-5."""
    q, k, v, g = _inputs(b, t, s, h, d, seed=t * 10 + s)
    mask, mask_np = _mask(kind, t, s)

    def loss(q, k, v):
        return (_jax_forward(q, k, v, mask_np) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fl.flash_attention(*leaves, mask).backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    """The plain backward follows the kernels' formulas (weights from lse,
    delta = rowsum(g * out)); autograd through the plain forward under the
    same dropout mask gives the same gradients, 2e-5."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 11, 17, 2, 8, 3))
    mask = _mask("random", 11, 17)[0]
    seed = 5 if rate else None
    out, lse = fl.flash_attention_reference(q, k, v, mask, seed, rate)
    got = fl.flash_attention_backward_reference(q, k, v, mask, seed, out,
                                                lse, g, rate)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = fl.flash_attention_reference(*leaves, mask, seed, rate)[0]
    for a, w in zip(got, torch.autograd.grad(ref, leaves, g)):
        assert (a - w).abs().max().item() <= 2e-5


@pytest.mark.parametrize("t,s,window", [(13, 13, None), (13, 13, 3),
                                        (9, 21, 4), (21, 9, None),
                                        (47, 47, 10)])
def test_index_mask_is_the_tensor_mask(t, s, window):
    """A BandMask describes the very masks the model builds, and the index
    path gives what the tensor path gives on the same mask."""
    band = fl.BandMask(t, s, window)
    tensor = band.tensor()
    if window is None and t == s:
        want = np.asarray(jax_layers.causal_mask(t))
        assert torch.equal(port_layers.causal_mask(t), tensor)
        assert port_layers.causal_mask(t, by_index=True) == band
    elif window is not None:
        want = np.asarray(jax_layers.banded_mask(t, s, window))
        assert torch.equal(port_layers.banded_mask(t, s, window), tensor)
        assert port_layers.banded_mask(t, s, window, by_index=True) == band
    else:
        want = np.arange(s)[None, :] <= np.arange(t)[:, None]
    np.testing.assert_array_equal(tensor.numpy(), want)
    # Rows that admit no key (T > S under a band) are out of contract.
    rows = tensor.any(dim=1)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, t, s, 2, 8, 1))
    results = []
    for mask in (band, tensor):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fl.flash_attention(*leaves, mask, 7, 0.2)
        (out * g)[:, rows].sum().backward()
        results.append([out.detach()[:, rows]] + [x.grad for x in leaves])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_autograd_keeps_nothing_of_size_t_by_s():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in _inputs(2, 13, 21, 2, 8, 2))
    out = fl.flash_attention(q, k, v, fl.BandMask(13, 21), 3, 0.1)
    kept = [tuple(x.shape) for x in out.grad_fn.saved_tensors]
    assert kept == [(2, 13, 2, 8), (2, 21, 2, 8), (2, 21, 2, 8),
                    (2, 13, 2, 8), (2, 2, 13)]
    assert out.requires_grad
    with torch.no_grad():
        assert fl.flash_attention(q, k, v).grad_fn is None


def _weights(out, cols):
    """(B, T, H, D) output under V = [I | 0] -> (B, H, T, cols) weights."""
    return out[..., :cols].permute(0, 2, 1, 3)


def test_dropout_mask_properties_of_the_plain_versions():
    """The share dropped; the backward redraws the forward's mask; the
    first rows of a batch draw the bits of a smaller batch; another seed
    draws another mask; the kept weights are scaled by 1 / (1 - rate) and
    the denominator sums the undropped weights."""
    b, t, h, d, rate = 6, 40, 3, 40, 0.25
    q, k, _, _ = (torch.from_numpy(x) for x in _inputs(b, t, t, h, d, 4))
    eye = torch.eye(t, d).view(1, t, 1, d).expand(b, t, h, d).contiguous()
    clean, lse = fl.flash_attention_reference(q, k, eye)
    out, lse_dropped = fl.flash_attention_reference(q, k, eye, None, 9, rate)
    kept = _weights(out, t) > 0
    keep = prng.keep_mask(prng.dropout_bits(
        9, b, h, t, t, key_word=prng.FLASH_KEY_WORD), rate)
    assert torch.equal(kept, keep)
    assert torch.equal(lse, lse_dropped)
    torch.testing.assert_close(_weights(out, t)[kept],
                               _weights(clean, t)[kept] / (1 - rate),
                               rtol=1e-6, atol=0)
    share = 1.0 - kept.float().mean().item()
    assert abs(share - rate) <= 4 * (rate * (1 - rate) / kept.numel()) ** 0.5
    # dv under g = [I | 0] is the transposed dropped weights.
    dv = fl.flash_attention_backward_reference(q, k, eye, None, 9, out, lse,
                                               eye, rate)[2]
    assert torch.equal(dv[..., :t].permute(0, 2, 3, 1) > 0, kept)
    prefix = fl.flash_attention_reference(q[:2], k[:2], eye[:2], None, 9,
                                          rate)[0]
    assert torch.equal(prefix, out[:2])
    other = fl.flash_attention_reference(q, k, eye, None, 10, rate)[0]
    assert not torch.equal(_weights(other, t) > 0, kept)
    # The stream is the flash kernels' own: the short-sequence attention's
    # bits under the same seed differ.
    assert not torch.equal(keep, prng.keep_mask(
        prng.dropout_bits(9, b, h, t, t), rate))


def test_flash_attention_refuses_bad_arguments():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 9, 9, 2, 8, 0))
    with pytest.raises(ValueError, match="BandMask of"):
        fl.flash_attention(q, k, v, fl.BandMask(9, 8))
    with pytest.raises(ValueError, match="window"):
        fl.flash_attention(q, k, v, fl.BandMask(9, 9, 0))
    with pytest.raises(ValueError, match="bool mask"):
        fl.flash_attention(q, k, v, torch.ones(9, 9))
    with pytest.raises(ValueError, match="explicit int32 seed"):
        fl.flash_attention(q, k, v, None, None, 0.1)
    with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
        fl.flash_attention(q, k, v, None, 1, 1.0)
    with pytest.raises(ValueError, match=r"\(B, T, H, D\)"):
        fl.flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(TypeError, match="one dtype"):
        fl.flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_dq(q, k, v, None, None, q,
                              torch.zeros(2, 2, 9), q)
