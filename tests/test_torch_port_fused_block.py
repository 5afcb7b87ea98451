"""The port's fused ViT sub-blocks (``ops/fused_block.py``) against the JAX
package's (``videocad_tpu/ops/fused_block.py``).

The same numpy inputs and weights go through both. The JAX side runs its
Pallas kernels in interpret mode at rate 0 (its in-kernel dropout needs the
TPU's generator); the port runs its plain versions, which is what a CPU
tensor gets. Tolerances at float32 are those of the JAX package's own tests
(``tests/test_fused_block.py``): 2e-5 forward, atol 5e-3 / rtol 2e-3 on the
gradients of a squared-sum loss or tighter; the JAX body approximates erf
to 1.5e-7 where the port uses the exact function, which those bounds cover.
Dropout is held by its properties on the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocad_tpu.ops import fused_block as jax_fb
from videocad_tpu_torch.ops import fused_block as fb
from videocad_tpu_torch.ops import prng


def _r(rng, shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mlp_params(rng, d=64, f=48):
    return (_r(rng, (d, f)), _r(rng, (f,)), _r(rng, (f, d)), _r(rng, (d,)),
            1 + _r(rng, (d,), 0.1), _r(rng, (d,)))


def _attn_params(rng, d=64, inner=64):
    return (_r(rng, (d, inner)), _r(rng, (d, inner)), _r(rng, (d, inner)),
            _r(rng, (inner, d)), _r(rng, (d,)), 1 + _r(rng, (d,), 0.1),
            _r(rng, (d,)))


def _t(arrays, dtype=None):
    out = [torch.from_numpy(np.asarray(a)) for a in arrays]
    if dtype is not None:
        out[0] = out[0].to(dtype)
    return out


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---- forward, float32 ----

@pytest.mark.parametrize("b,t", [(4, 10), (3, 7), (1, 5)])
def test_mlp_block_forward_matches_jax(b, t):
    rng = np.random.default_rng(0)
    args = (_r(rng, (b, t, 64)),) + _mlp_params(rng)
    want = jax_fb.mlp_block(*_j(args), 0)
    got = fb.mlp_block(*_t(args), None)
    assert got.shape == (b, t, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,t,heads", [(4, 10, 4), (2, 9, 2), (1, 5, 1)])
def test_attn_block_forward_matches_jax(b, t, heads):
    rng = np.random.default_rng(2)
    args = (_r(rng, (b, t, 64)),) + _attn_params(rng)
    want = jax_fb.attn_block(*_j(args), 0, heads)
    got = fb.attn_block(*_t(args), None, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ---- gradients, float32 ----

def _port_grads(fn, args, *rest):
    leaves = [a.clone().requires_grad_() for a in _t(args)]
    (fn(*leaves, *rest) ** 2).sum().backward()
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("b,t", [(4, 10), (3, 7)])
def test_mlp_block_gradients_match_jax(b, t):
    """dx and every parameter's gradient of sum(y^2) against jax.grad through
    the interpreted Pallas forward and backward kernels: atol 5e-4, rtol
    2e-3 (the JAX package's own test allows atol 5e-3)."""
    rng = np.random.default_rng(1)
    args = (_r(rng, (b, t, 64)),) + _mlp_params(rng)
    want = jax.grad(lambda *a: (jax_fb.mlp_block(*a, 0) ** 2).sum(),
                    argnums=tuple(range(7)))(*_j(args))
    got = _port_grads(fb.mlp_block, args, None)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=2e-3, err_msg=f"grad {i}")


@pytest.mark.parametrize("b,t,heads", [(4, 10, 4), (2, 9, 2)])
def test_attn_block_gradients_match_jax(b, t, heads):
    rng = np.random.default_rng(3)
    args = (_r(rng, (b, t, 64)),) + _attn_params(rng)
    want = jax.grad(lambda *a: (jax_fb.attn_block(*a, 0, heads) ** 2).sum(),
                    argnums=tuple(range(8)))(*_j(args))
    got = _port_grads(fb.attn_block, args, None, heads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        # Entries reach 1e3 here: the JAX package's own bound.
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3,
                                   rtol=2e-3, err_msg=f"grad {i}")


@pytest.mark.parametrize("op", ["mlp", "attn"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_written_out_backward_matches_autograd_through_the_forward(op, rate):
    """The plain backward (the kernel's formulas) against autograd through
    the plain forward, with and without dropout: 1e-4 of each gradient's
    largest entry."""
    rng = np.random.default_rng(4)
    seed = 77 if rate else None
    x = _r(rng, (3, 7, 64))
    gy = torch.from_numpy(_r(rng, (3, 7, 64), 1.0))
    if op == "mlp":
        args, rest = (x,) + _mlp_params(rng), (seed, rate)
        forward, backward = (fb.mlp_block_reference,
                             fb.mlp_block_backward_reference)
    else:
        args, rest = (x,) + _attn_params(rng), (seed, 4, rate)
        forward, backward = (fb.attn_block_reference,
                             fb.attn_block_backward_reference)
    leaves = [a.clone().requires_grad_() for a in _t(args)]
    want = torch.autograd.grad(forward(*leaves, *rest), leaves, gy)
    got = backward(*_t(args), gy, *rest)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), f"grad {i}: {err}"


# ---- bf16 ----

def _bf16_ulps(got, want):
    """The largest difference in units of the bf16 spacing at ``want``."""
    want = want.float()
    spacing = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -120))) - 7)
    return ((got.float() - want).abs() / spacing).max().item()


@pytest.mark.parametrize("op", ["mlp", "attn"])
def test_bf16_forward_matches_jax_within_two_ulps(op):
    """Both sides round at the same places; sums in another order can move a
    rounded intermediate by one ulp, which the output's own rounding can
    carry to two of its ulps."""
    rng = np.random.default_rng(5)
    x = _r(rng, (2, 8, 64), 1.0)
    if op == "mlp":
        params = _mlp_params(rng)
        want = jax_fb.mlp_block(jnp.asarray(x, jnp.bfloat16), *_j(params), 0)
        got = fb.mlp_block(*_t((x,) + params, torch.bfloat16), None)
    else:
        params = _attn_params(rng)
        want = jax_fb.attn_block(jnp.asarray(x, jnp.bfloat16), *_j(params),
                                 0, 4)
        got = fb.attn_block(*_t((x,) + params, torch.bfloat16), None, 4)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    assert _bf16_ulps(got, want) <= 2.0


def test_bf16_gradients_are_float32_for_parameters_and_bf16_for_x():
    rng = np.random.default_rng(6)
    args = _t((_r(rng, (2, 6, 64)),) + _attn_params(rng), torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in args]
    fb.attn_block(*leaves, 5, 4, 0.2).float().sum().backward()
    assert leaves[0].grad.dtype == torch.bfloat16
    assert all(leaf.grad.dtype == torch.float32 for leaf in leaves[1:])
    assert all(torch.isfinite(leaf.grad.float()).all() for leaf in leaves)


# ---- what the backward keeps ----

@pytest.mark.parametrize("op", ["mlp", "attn"])
def test_autograd_keeps_only_x_and_the_parameters(op):
    rng = np.random.default_rng(7)
    x = _r(rng, (3, 7, 64))
    if op == "mlp":
        args, rest, fn = (x,) + _mlp_params(rng, f=128), (9, 0.1), fb.mlp_block
    else:
        args, rest, fn = ((x,) + _attn_params(rng, inner=128), (9, 4, 0.1),
                          fb.attn_block)
    leaves = [a.clone().requires_grad_() for a in _t(args)]
    saved = []

    def pack(tensor):
        saved.append(tensor)
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = fn(*leaves, *rest)
    assert len(saved) == len(leaves)
    inputs = {leaf.data_ptr(): leaf for leaf in leaves}
    for tensor in saved:
        # Each saved tensor is one of the inputs themselves: nothing of the
        # width of q, k, v or of the hidden layer, no mask, no weights.
        assert tensor.data_ptr() in inputs
        assert tensor.numel() == inputs[tensor.data_ptr()].numel()
    assert max(t.numel() for t in saved) == max(a.numel() for a in leaves)
    y.sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)


# ---- dropout, by its properties ----

B, T, D, F, H = 6, 10, 64, 96, 4
SITE_SHAPES = {prng.SITE_ATTN_W: (H, T, T), prng.SITE_ATTN_RES: (1, T, D),
               prng.SITE_MLP_HID: (1, T, F), prng.SITE_MLP_RES: (1, T, D)}


@pytest.mark.parametrize("site", sorted(SITE_SHAPES))
def test_each_site_drops_its_share(site):
    heads, rows, cols = SITE_SHAPES[site]
    scale = fb.keep_scale(3, site, 64, heads, rows, cols, 0.1)
    assert scale.shape == (64, heads, rows, cols)
    share = (scale == 0).float().mean().item()
    assert abs(share - 0.1) < 0.01
    assert torch.all((scale == 0) | (scale == torch.tensor(1 / 0.9)))


def test_sites_and_seeds_draw_different_masks_under_their_own_key_words():
    masks = {(seed, site): prng.block_site_bits(seed, site, 2, 1, T, D)
             for seed in (1, 2) for site in (prng.SITE_ATTN_RES,
                                             prng.SITE_MLP_RES,
                                             prng.SITE_MLP_HID)}
    keys = sorted(masks)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(masks[a], masks[b]), (a, b)
    # The four sites' key words are 3..6: none of the short-sequence
    # attention kernels' (0), the standalone dropout's (1) or the flash
    # attention kernels' (2).
    words = {prng.BLOCK_KEY_WORD + site for site in SITE_SHAPES}
    assert words == {3, 4, 5, 6} and not words & {0, 1, prng.FLASH_KEY_WORD}
    for site in SITE_SHAPES:
        heads, rows, cols = SITE_SHAPES[site]
        ours = prng.block_site_bits(9, site, 2, heads, rows, cols)
        for word in (0, 1, prng.FLASH_KEY_WORD):
            assert not torch.equal(ours, prng.dropout_bits(
                9, 2, heads, rows, cols, key_word=word))
        assert torch.equal(ours, prng.dropout_bits(
            9, 2, heads, rows, cols, key_word=3 + site))
    with pytest.raises(ValueError, match="unknown dropout site"):
        prng.block_site_bits(9, 4, 1, 1, 2, 2)


@pytest.mark.parametrize("op", ["mlp", "attn"])
def test_the_mask_is_the_same_when_the_batch_is_cut_in_two(op):
    rng = np.random.default_rng(8)
    x = _r(rng, (B, T, D))
    if op == "mlp":
        args, rest, fn = (x,) + _mlp_params(rng, f=F), (21, 0.3), \
            fb.mlp_block_reference
    else:
        args, rest, fn = (x,) + _attn_params(rng), (21, H, 0.3), \
            fb.attn_block_reference
    tensors = _t(args)
    whole = fn(*tensors, *rest)
    first = fn(tensors[0][:2], *tensors[1:], *rest)
    second = fn(tensors[0][2:], *tensors[1:], *rest, frame_offset=2)
    assert torch.equal(torch.cat([first, second]), whole)
    unshifted = fn(tensors[0][2:], *tensors[1:], *rest)
    assert not torch.equal(unshifted, second)


def test_forward_and_backward_draw_one_mask():
    """The MLP branch's mask is read off the output (y - x is 0 where the
    branch was dropped), and the written-out backward must redraw it: with
    the upstream gradient 1, db2 = sum(do) counts exactly the kept entries
    of each column times 1 / (1 - rate)."""
    rng = np.random.default_rng(9)
    rate, seed = 0.4, 31
    args = _t((_r(rng, (B, T, D)),) + _mlp_params(rng, f=F))
    y = fb.mlp_block_reference(*args, seed, rate)
    kept = (y - args[0]) != 0
    assert abs((~kept).float().mean().item() - rate) < 0.03
    grads = fb.mlp_block_backward_reference(*args, torch.ones_like(y), seed,
                                            rate)
    db2 = grads[4]
    np.testing.assert_allclose(
        db2.numpy(), kept.reshape(-1, D).sum(0).float().numpy() / (1 - rate),
        rtol=1e-5)
    # The same for the attention branch and dbo.
    args = _t((_r(rng, (B, T, D)),) + _attn_params(rng))
    y = fb.attn_block_reference(*args, seed, H, rate)
    kept = (y - args[0]) != 0
    grads = fb.attn_block_backward_reference(*args, torch.ones_like(y), seed,
                                             H, rate)
    np.testing.assert_allclose(
        grads[5].numpy(),
        kept.reshape(-1, D).sum(0).float().numpy() / (1 - rate), rtol=1e-5)


def test_dropped_hidden_units_get_no_gradient():
    """Site 2: a hidden unit that the forward dropped contributes nothing,
    so the gradient of b1 under autograd (through the plain forward) equals
    the written-out backward's, which multiplies by its own redrawn mask;
    and with every hidden unit dropped but the kept ones, a wrong mask would
    move db1 by whole entries."""
    rng = np.random.default_rng(10)
    rate, seed = 0.5, 5
    args = _t((_r(rng, (B, T, D)),) + _mlp_params(rng, f=F))
    leaves = [a.clone().requires_grad_() for a in args]
    gy = torch.from_numpy(_r(rng, (B, T, D), 1.0))
    want = torch.autograd.grad(fb.mlp_block_reference(*leaves, seed, rate),
                               leaves, gy)
    got = fb.mlp_block_backward_reference(*args, gy, seed, rate)
    other = fb.mlp_block_backward_reference(*args, gy, seed + 1, rate)
    assert (got[2] - want[2]).abs().max() <= 1e-4 * want[2].abs().max()
    assert (other[2] - want[2]).abs().max() > 0.05 * want[2].abs().max()


def test_rate_and_seed_are_checked():
    rng = np.random.default_rng(11)
    args = _t((_r(rng, (2, 5, 64)),) + _mlp_params(rng))
    with pytest.raises(ValueError, match="explicit int32 seed"):
        fb.mlp_block(*args, None, 0.1)
    with pytest.raises(ValueError, match="not in"):
        fb.mlp_block(*args, 3, 1.0)
    with pytest.raises(ValueError, match="w1 \\(D, F\\)"):
        fb.mlp_block(args[0], args[1].t(), *args[2:], None)
    attn = _t((_r(rng, (2, 5, 64)),) + _attn_params(rng))
    with pytest.raises(ValueError, match="explicit int32 seed"):
        fb.attn_block(*attn, None, 4, 0.1)
    with pytest.raises(ValueError, match="multiple of"):
        fb.attn_block(*attn, None, 5)
    with pytest.raises(ValueError, match="wq, wk, wv"):
        fb.attn_block(attn[0], attn[1].t()[:, :32], *attn[2:], None, 4)


def test_a_weight_may_be_a_transposed_view():
    """The model hands the kernels ``weight.t()`` of parameters stored (out,
    in): the functions take the view, and its gradient comes back in the
    view's layout, so the stored parameter's gradient is contiguous."""
    rng = np.random.default_rng(12)
    args = _t((_r(rng, (2, 5, 64)),) + _mlp_params(rng))
    stored = [args[1].t().contiguous().requires_grad_(),
              args[3].t().contiguous().requires_grad_()]
    y = fb.mlp_block(args[0], stored[0].t(), args[2], stored[1].t(),
                     *args[4:], None)
    assert torch.equal(y, fb.mlp_block(*args, None))
    y.sum().backward()
    want = _port_grads(fb.mlp_block, [a.numpy() for a in args], None)
    assert stored[0].grad.shape == (48, 64) and want[1].shape == (64, 48)
    assert stored[0].grad.is_contiguous() and stored[1].grad.is_contiguous()
