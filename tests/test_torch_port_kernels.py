"""The port's hand-written kernels against their plain PyTorch versions,
on the card, and the device feed's pinned copies. Every test here needs a
CUDA card and skips without one.

The file imports neither jax nor the JAX package, so on a machine without
jax it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from videocad_tpu_torch.ops import dropout as dr
from videocad_tpu_torch.ops import fused_attention as fa
from videocad_tpu_torch.ops import layernorm as ln
from videocad_tpu_torch.ops import preprocess as pp
from videocad_tpu_torch.ops import prng

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(b, t, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


# bf16: the summation order may differ and the weights round to bf16 at
# the same place in both versions, so a few bf16 ulps of the output.
@pytest.mark.parametrize("b,t,h,d,dtype,max_tol", [
    (1, 50, 16, 64, BF16, 2e-2),    # the flagship ViT: CAD encode
    (8, 50, 16, 64, BF16, 2e-2),    # one served tick
    (8, 50, 16, 64, F32, 1e-5),
    (3, 13, 2, 8, F32, 1e-5),       # T < 32: every lane's 2nd key is padding
    (2, 64, 4, 32, F32, 1e-5),      # T at the kernel's limit
    (5, 33, 3, 48, BF16, 2e-2),     # uneven T and D
])
def test_mhsa_short_kernel_matches_plain_version(cuda, b, t, h, d, dtype,
                                                 max_tol):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    with torch.no_grad():
        before = fa.mhsa_short.launches
        got = fa.mhsa_short(q, k, v, None, h)
        torch.cuda.synchronize()
        assert fa.mhsa_short.launches == before + 1
        want = fa.mhsa_short_reference(q, k, v, None, h)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= max_tol
    assert err.mean().item() <= (1e-3 if dtype == BF16 else 1e-6)


def test_mhsa_short_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 50, 1024, F32, seed=0)
    with torch.no_grad():
        with pytest.raises(TypeError):
            fa.mhsa_short(q.half(), k.half(), v.half(), None, 16)
        with pytest.raises(ValueError, match="contiguous"):
            fa.mhsa_short(q.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v, None, 16)
        with pytest.raises(ValueError, match="T <= 64"):
            fa.mhsa_short(*_qkv(1, 65, 64, F32, seed=1), None, 1)
        with pytest.raises(ValueError, match="D <= 64"):
            fa.mhsa_short(*_qkv(1, 8, 128, F32, seed=2), None, 1)
    with pytest.raises(ValueError, match="explicit int32 seed"):
        fa.mhsa_short(q.requires_grad_(), k, v, None, 16, 0.1)


@pytest.mark.parametrize("b,t,h,d,dtype,rate", [
    (8, 50, 16, 64, BF16, 0.1),
    (8, 50, 16, 64, F32, 0.1),
    (3, 13, 2, 8, F32, 0.5),
    (2, 64, 4, 64, BF16, 0.25),     # D == T: the mask is read off the output
    (4, 32, 2, 32, F32, 0.3),
])
def test_mhsa_short_kernel_draws_the_plain_versions_mask(cuda, b, t, h, d,
                                                         dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    with torch.no_grad():
        got = fa.mhsa_short(q, k, v, 4242, h, rate)
        want = fa.mhsa_short_reference(q, k, v, 4242, h, rate)
        other = fa.mhsa_short(q, k, v, 4243, h, rate)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= (2e-2 if dtype == BF16 else 1e-5)
    assert not torch.equal(got, other)
    if d == t:
        # V = identity per head: the output is the dropped weights, so the
        # kept set is read off the output and must be the bit function's.
        eye = torch.eye(t, device="cuda", dtype=dtype).repeat(1, h).expand(
            b, t, h * t).contiguous()
        with torch.no_grad():
            dropped = fa.mhsa_short(q, k, eye, 4242, h, rate)
        keep = dropped.reshape(b, t, h, t).permute(0, 2, 1, 3) > 0
        bits = prng.dropout_bits(4242, b, h, t, t, device="cuda")
        weights_positive = fa.mhsa_short(q, k, eye, None, h).reshape(
            b, t, h, t).permute(0, 2, 1, 3) > 0
        assert torch.equal(keep, prng.keep_mask(bits, rate)
                           & weights_positive)


@pytest.mark.parametrize("b,t,h,d,dtype,rate", [
    (8, 50, 16, 64, BF16, 0.0),
    (8, 50, 16, 64, BF16, 0.1),
    (8, 50, 16, 64, F32, 0.0),
    (8, 50, 16, 64, F32, 0.1),
    (3, 13, 2, 8, F32, 0.3),        # T < 32
    (2, 64, 4, 32, F32, 0.1),       # T at the kernel's limit
    (5, 33, 3, 48, BF16, 0.1),      # uneven T and D
])
def test_mhsa_short_backward_kernel_matches_plain_version(cuda, b, t, h, d,
                                                          dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t + 1)
    g = _qkv(b, t, h * d, dtype, seed=7)[0]
    seed = 99 if rate else None
    before = (fa.mhsa_short.launches, fa.mhsa_short_backward.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.mhsa_short(*leaves, seed, h, rate)
    # A non-contiguous gradient, as autograd may hand over.
    out.backward(g.transpose(0, 1).contiguous().transpose(0, 1))
    torch.cuda.synchronize()
    assert (fa.mhsa_short.launches, fa.mhsa_short_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.mhsa_short_backward_reference(q, k, v, g, seed, h, rate)
    for leaf, w in zip(leaves, want):
        err = (leaf.grad.float() - w.float()).abs()
        assert leaf.grad.dtype == dtype
        assert err.max().item() <= (2e-2 if dtype == BF16 else 1e-5)
        assert err.mean().item() <= (1e-3 if dtype == BF16 else 1e-6)
    if dtype == F32:
        # And against autograd through the plain forward (same mask).
        again = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = fa.mhsa_short_reference(*again, seed, h, rate)
        for leaf, w in zip(leaves, torch.autograd.grad(ref, again, g)):
            assert (leaf.grad - w).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,target,tol", [
    ((4, 3, 224, 224, 3), None, 1e-6),
    ((2, 37, 53, 3), None, 1e-6),          # a pixel count off the 4-grid
    ((3, 256, 256, 3), (224, 224), 1e-5),
    ((2, 2, 40, 56, 3), (24, 32), 1e-5),
    ((2, 7, 9, 3), (14, 18), 1e-5),        # upscaling: clamped edge taps
])
def test_gray_kernels_match_the_plain_version(cuda, shape, target, tol):
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                           device="cuda")
    fused = pp.grayscale_normalize_fused
    before = (fused.launches, fused.resize_launches)
    got = pp.maybe_preprocess(images, True, impl="pallas",
                              target_size=target)
    torch.cuda.synchronize()
    assert (fused.launches, fused.resize_launches) == (
        before[0] + (target is None), before[1] + (target is not None))
    want = pp.grayscale_normalize(images, True, target)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
    # A non-contiguous view (the train step's frames[:, :-1]) is copied.
    if images.dim() == 5:
        view = images[:, :-1]
        got = pp.grayscale_normalize_fused(view, True, target)
        assert (got - pp.grayscale_normalize(view, True, target)
                ).abs().max().item() <= tol


# ---- K4: LayerNorm ----

def _ln_inputs(rows, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(rows, d) * 2.0 + 0.5).to(dtype)
    return (x, 1.0 + 0.1 * randn(d), 0.1 * randn(d), randn(rows, d).to(dtype))


def _within_one_bf16_ulp(got, want):
    """One unit in the last place of bf16 at ``want``'s magnitude, 1e-5
    where ``want`` is nearer 0 than that (a float32 cancellation)."""
    w = want.float()
    exponent = torch.frexp(w.abs().clamp_min(1e-30))[1]
    ulp = torch.ldexp(torch.ones_like(w), exponent - 8).clamp_min(1e-5)
    return bool(((got.float() - w).abs() <= ulp).all())


@pytest.mark.parametrize("rows,d,dtype", [
    (400, 512, BF16),      # the CAD encoder's rows
    (392, 1024, BF16),     # its patch_norm_in
    (400, 512, F32),
    (7, 32, F32),          # fewer rows than warps in a block
    (1037, 512, BF16),     # rows no multiple of anything
    (37, 100, BF16),       # d off the 16-byte vector: the scalar path
    (37, 30, F32),
])
def test_layer_norm_kernels_match_plain_versions(cuda, rows, d, dtype):
    x, scale, bias, g = _ln_inputs(rows, d, dtype, seed=rows + d)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    marks = (ln.layer_norm.launches, ln.layer_norm_backward.launches)
    out = ln.layer_norm(*leaves, 1e-5)
    out.backward(g)
    torch.cuda.synchronize()
    assert (ln.layer_norm.launches, ln.layer_norm_backward.launches) == (
        marks[0] + 1, marks[1] + 1)
    with torch.no_grad():
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
        want_dx, want_dscale, want_dbias = ln.layer_norm_backward_plain(
            x, scale, g, 1e-5)
    assert out.dtype == dtype and leaves[0].grad.dtype == dtype
    assert leaves[1].grad.dtype == F32 and leaves[2].grad.dtype == F32
    if dtype == BF16:
        assert _within_one_bf16_ulp(out, want)
        assert _within_one_bf16_ulp(leaves[0].grad, want_dx)
    else:
        assert (out - want).abs().max().item() <= 1e-5
        assert (leaves[0].grad - want_dx).abs().max().item() <= 1e-5
    # Sums over the rows in another order: 1e-4 of the largest entry.
    for got, ref in ((leaves[1].grad, want_dscale), (leaves[2].grad,
                                                     want_dbias)):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


def test_layer_norm_parameter_gradients_repeat_exactly(cuda):
    """Two passes and no atomics: dscale and dbias are the same bits in
    every run."""
    x, scale, _, g = _ln_inputs(5000, 512, BF16, seed=3)
    first = ln.layer_norm_backward(x, scale, g, 1e-5)
    second = ln.layer_norm_backward(x, scale, g, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_layer_norm_kernel_refuses_what_it_does_not_take(cuda):
    x, scale, bias, _ = _ln_inputs(4, 64, F32, seed=0)
    with pytest.raises(TypeError):
        ln.layer_norm(x.half(), scale, bias)
    with pytest.raises(TypeError, match="float32 scale"):
        ln.layer_norm(x, scale.double(), bias.double())
    wide = torch.zeros(4, 2048, device="cuda")
    with pytest.raises(ValueError, match="D <= 1024"):
        ln.layer_norm(wide, torch.ones(2048, device="cuda"),
                      torch.zeros(2048, device="cuda"))
    empty = ln.layer_norm(x[:0], scale, bias)
    assert empty.shape == (0, 64)


# ---- K5: the standalone dropout ----

@pytest.mark.parametrize("shape,dtype", [
    ((8, 50, 512), BF16),
    ((8, 50, 512), F32),
    ((2, 4, 191, 191), BF16),     # the decoder's attention weights
    ((1000003,), BF16),           # an odd size: the ragged tail
    ((5,), F32),
])
def test_hw_dropout_kernel_equals_plain_version(cuda, shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = dr.hw_dropout.launches
    got = dr.hw_dropout(x, 77, 0.1)
    torch.cuda.synchronize()
    assert dr.hw_dropout.launches == before + 1
    assert torch.equal(got, dr.hw_dropout_plain(x, 77, 0.1))


def test_hw_dropout_kernel_mask_properties(cuda):
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((64, 50, 512), generator=gen, device="cuda").to(BF16)
    x[x == 0] = 1.0
    flat = x.reshape(-1)
    full = dr.hw_dropout(x, 5, 0.1)
    share = (full == 0).float().mean().item()
    assert abs(share - 0.1) <= 4 * (0.09 / x.numel()) ** 0.5
    assert torch.equal(full, dr.hw_dropout(x, 5, 0.1))
    assert not torch.equal(full != 0, dr.hw_dropout(x, 6, 0.1) != 0)
    # A flat prefix runs under another grid; a view that starts one element
    # in is not aligned for the vector accesses. One mask all the same.
    for k in (1, 4097, 1000003):
        assert torch.equal(dr.hw_dropout(flat[:k], 5, 0.1),
                           full.reshape(-1)[:k])
    assert torch.equal(dr.hw_dropout(flat[1:4097], 5, 0.1) != 0,
                       full.reshape(-1)[:4096] != 0)
    # A non-contiguous tensor is masked by its row-major elements.
    t = x.transpose(0, 1)
    assert torch.equal(dr.hw_dropout(t, 5, 0.1),
                       dr.hw_dropout(t.contiguous(), 5, 0.1))
    leaf = x.clone().requires_grad_()
    g = torch.randn(x.shape, generator=gen, device="cuda").to(BF16)
    dr.hw_dropout(leaf, 5, 0.1).backward(g)
    assert torch.equal(leaf.grad, dr.hw_dropout(g, 5, 0.1))
    with pytest.raises(TypeError):
        dr.hw_dropout(x.half(), 5, 0.1)


# ---- the device feed ----

def test_device_prefetch_on_the_card_returns_every_batch_in_order(
        cuda, tmp_path):
    """Pinned host tensors, copies on a side stream, an event per batch:
    every batch arrives unchanged and in order, whatever is in flight."""
    import numpy as np

    from videocad_tpu_torch.data.dataset import VideoCADDataset
    from videocad_tpu_torch.data.pipeline import DataPipeline, device_prefetch
    from videocad_tpu_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(str(tmp_path), num_sequences=12, min_len=20,
                            max_len=40, image_size=64, seed=1)
    pipe = DataPipeline(VideoCADDataset(str(tmp_path)), batch_size=2,
                        shuffle=False, buckets=(48,))
    source = list(pipe.epoch(0))
    for size in (1, 2, 4):
        count = 0
        for got, want in zip(device_prefetch(iter(source), cuda, size),
                             source):
            # Work on the consumer's stream while later copies are in flight.
            busy = torch.randn(1024, 1024, device="cuda")
            busy = busy @ busy
            assert got["ids"] == want["ids"]
            for key in ("frames", "actions", "cad_image", "timesteps"):
                assert got[key].device.type == "cuda"
                np.testing.assert_array_equal(got[key].cpu().numpy(),
                                              want[key])
            count += 1
        assert count == len(source) == 6
