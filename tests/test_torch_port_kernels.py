"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and skips without one.

The file imports neither jax nor the JAX package, so on a machine without
jax it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from videocad_tpu_torch.ops import fused_attention as fa
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
