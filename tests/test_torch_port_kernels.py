"""The port's hand-written kernels against their plain PyTorch versions,
on the card, and the device feed's pinned copies. Every test here needs a
CUDA card and skips without one.

The file imports neither jax nor the JAX package, so on a machine without
jax it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from videocad_tpu_torch.ops import attention as fl
from videocad_tpu_torch.ops import dropout as dr
from videocad_tpu_torch.ops import fused_attention as fa
from videocad_tpu_torch.ops import fused_block as fb
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


def _launched(counted, before, variant):
    """The launch counters of ``counted`` moved by one launch of
    ``variant`` since ``before`` (launches, tc_launches)."""
    return (counted.launches, counted.tc_launches) == (
        before[0] + 1, before[1] + (variant == "tc"))


# bf16: the summation order may differ and the weights round to bf16 at
# the same place in both versions, so a few bf16 ulps of the output.
@pytest.mark.parametrize("b,t,h,d,dtype,max_tol", [
    (1, 50, 16, 64, BF16, 2e-2),    # the flagship ViT: CAD encode
    (8, 50, 16, 64, BF16, 2e-2),    # one served tick
    (8, 50, 16, 64, F32, 1e-5),
    (3, 13, 2, 8, F32, 1e-5),       # T < 32: every lane's 2nd key is padding
    (2, 64, 4, 32, F32, 1e-5),      # T at the kernel's limit
    (5, 33, 3, 48, BF16, 2e-2),     # uneven T and D
    (6, 1, 4, 64, BF16, 2e-2),      # tc: one key, one query row
    (4, 17, 4, 64, BF16, 2e-2),     # tc: one row and key past a 16-row tile
    (3, 64, 4, 64, BF16, 2e-2),     # tc: T at the limit, no padding
    (4, 17, 2, 16, BF16, 2e-2),     # tc: the narrowest head
    (3, 50, 4, 16, BF16, 2e-2),
    (3, 13, 2, 8, BF16, 2e-2),      # scalar: D not a multiple of 16
])
def test_mhsa_short_kernel_matches_plain_version(cuda, b, t, h, d, dtype,
                                                 max_tol):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    variant = fa._kernel_variant(dtype, t, d)
    assert variant == ("tc" if dtype == BF16 and d % 16 == 0 else "scalar")
    with torch.no_grad():
        before = (fa.mhsa_short.launches, fa.mhsa_short.tc_launches)
        got = fa.mhsa_short(q, k, v, None, h)
        torch.cuda.synchronize()
        assert _launched(fa.mhsa_short, before, variant)
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
        with pytest.raises(ValueError, match="T <= 128"):
            fa.mhsa_short(*_qkv(1, 129, 64, F32, seed=1), None, 1)
        # T = 65 is taken, by the wide instantiation.
        before = fa.mhsa_short.wide_launches
        fa.mhsa_short(*_qkv(1, 65, 64, F32, seed=1), None, 1)
        assert fa.mhsa_short.wide_launches == before + 1
        with pytest.raises(ValueError, match="D <= 64"):
            fa.mhsa_short(*_qkv(1, 8, 128, F32, seed=2), None, 1)
    with pytest.raises(ValueError, match="explicit int32 seed"):
        fa.mhsa_short(q.requires_grad_(), k, v, None, 16, 0.1)


@pytest.mark.parametrize("b,t,h,d,dtype,rate", [
    (8, 50, 16, 64, BF16, 0.1),
    (8, 50, 16, 64, F32, 0.1),
    (3, 13, 2, 8, F32, 0.5),
    (2, 64, 4, 64, BF16, 0.25),
    (4, 32, 2, 32, F32, 0.3),
    (64, 1, 4, 64, BF16, 0.1),      # tc at T = 1, 17; D = 16 < T = 17
    (4, 17, 4, 64, BF16, 0.3),
    (3, 17, 2, 16, BF16, 0.5),
    (5, 16, 2, 16, BF16, 0.3),
    (3, 13, 2, 8, BF16, 0.3),       # scalar bf16
])
def test_mhsa_short_kernel_draws_the_plain_versions_mask(cuda, b, t, h, d,
                                                         dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    variant = fa._kernel_variant(dtype, t, d)
    with torch.no_grad():
        before = (fa.mhsa_short.launches, fa.mhsa_short.tc_launches)
        got = fa.mhsa_short(q, k, v, 4242, h, rate)
        assert _launched(fa.mhsa_short, before, variant)
        want = fa.mhsa_short_reference(q, k, v, 4242, h, rate)
        other = fa.mhsa_short(q, k, v, 4243, h, rate)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= (2e-2 if dtype == BF16 else 1e-5)
    assert not torch.equal(got, other)
    if d >= t:
        # V = [I_T | 0] per head: the output is the dropped weights, so the
        # kept set is read off the output and must be the bit function's;
        # with the output gradient [I_T | 0] too, dv is their transpose, so
        # the backward's kept set is read off dv.
        eye = torch.eye(t, d, device="cuda", dtype=dtype).repeat(1, h).expand(
            b, t, h * d).contiguous()
        weights = lambda x: x.reshape(b, t, h, d)[..., :t].permute(  # noqa: E731
            0, 2, 1, 3)
        with torch.no_grad():
            dropped = fa.mhsa_short(q, k, eye, 4242, h, rate)
            _, _, dv = fa.mhsa_short_backward(q, k, eye, eye, 4242, h, rate)
        keep = weights(dropped) > 0
        bits = prng.dropout_bits(4242, b, h, t, t, device="cuda")
        weights_positive = weights(fa.mhsa_short(q, k, eye, None, h)) > 0
        assert torch.equal(keep, prng.keep_mask(bits, rate)
                           & weights_positive)
        assert torch.equal(weights(dv).transpose(-1, -2) > 0, keep)


@pytest.mark.parametrize("b,t,h,d,dtype,rate", [
    (8, 50, 16, 64, BF16, 0.0),
    (8, 50, 16, 64, BF16, 0.1),
    (8, 50, 16, 64, F32, 0.0),
    (8, 50, 16, 64, F32, 0.1),
    (3, 13, 2, 8, F32, 0.3),        # T < 32
    (2, 64, 4, 32, F32, 0.1),       # T at the kernel's limit
    (5, 33, 3, 48, BF16, 0.1),      # uneven T and D
    (6, 1, 4, 64, BF16, 0.1),       # tc: one key (ds = 0)
    (4, 17, 4, 64, BF16, 0.1),      # tc: padded query and key rows
    (3, 64, 4, 64, BF16, 0.1),      # tc: no padding
    (4, 17, 2, 16, BF16, 0.0),      # tc: the narrowest head
    (3, 50, 4, 16, BF16, 0.1),
    (3, 13, 2, 8, BF16, 0.1),       # scalar bf16
])
def test_mhsa_short_backward_kernel_matches_plain_version(cuda, b, t, h, d,
                                                          dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t + 1)
    g = _qkv(b, t, h * d, dtype, seed=7)[0]
    seed = 99 if rate else None
    variant = fa._kernel_variant(dtype, t, d)
    before = (fa.mhsa_short.launches, fa.mhsa_short_backward.launches,
              fa.mhsa_short_backward.tc_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.mhsa_short(*leaves, seed, h, rate)
    # A non-contiguous gradient, as autograd may hand over.
    out.backward(g.transpose(0, 1).contiguous().transpose(0, 1))
    torch.cuda.synchronize()
    assert fa.mhsa_short.launches == before[0] + 1
    assert _launched(fa.mhsa_short_backward, before[1:], variant)
    # No atomics: a second launch gives the same gradients to the bit.
    again = fa.mhsa_short_backward(q, k, v, g, seed, h, rate)
    for leaf, x in zip(leaves, again):
        assert torch.equal(leaf.grad, x)
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


# ---- K1's wide instantiation: 64 < T <= 128 (the GenCAD CAD encoder) ----

def _k1_counts(counted):
    return counted.launches, counted.tc_launches, counted.wide_launches


def _launched_wide(counted, before, variant):
    """One launch of the wide ``variant`` since ``before`` (launches,
    tc_launches, wide_launches)."""
    return _k1_counts(counted) == (before[0] + 1,
                                   before[1] + variant.startswith("tc"),
                                   before[2] + 1)


# (B, T, H, D, dtype): the GenCAD CAD encoder at B = 8 and 1 (T = 65, 16
# heads of 64), T at the limit, uneven T and D, float32 and bf16 with D no
# multiple of 16 on the scalar variant.
WIDE_CASES = [
    (8, 65, 16, 64, BF16),
    (1, 65, 16, 64, BF16),
    (3, 128, 4, 64, BF16),
    (2, 97, 3, 32, BF16),
    (2, 81, 2, 16, BF16),
    (8, 65, 16, 64, F32),
    (2, 128, 4, 64, F32),
    (3, 100, 2, 8, BF16),
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,h,d,dtype", WIDE_CASES)
def test_mhsa_short_wide_kernel_matches_plain_version(cuda, b, t, h, d,
                                                      dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t)
    seed = 77 if rate else None
    variant = fa._kernel_variant(dtype, t, d)
    assert variant == ("tc_wide" if dtype == BF16 and d % 16 == 0
                       else "scalar_wide")
    with torch.no_grad():
        before = _k1_counts(fa.mhsa_short)
        got = fa.mhsa_short(q, k, v, seed, h, rate)
        torch.cuda.synchronize()
        assert _launched_wide(fa.mhsa_short, before, variant)
        want = fa.mhsa_short_reference(q, k, v, seed, h, rate)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= (2e-2 if dtype == BF16 else 1e-5)
    assert err.mean().item() <= (1e-3 if dtype == BF16 else 1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,h,d,dtype", WIDE_CASES)
def test_mhsa_short_wide_backward_kernel_matches_plain_version(
        cuda, b, t, h, d, dtype, rate):
    q, k, v = _qkv(b, t, h * d, dtype, seed=b * 1000 + t + 1)
    g = _qkv(b, t, h * d, dtype, seed=7)[0]
    seed = 99 if rate else None
    variant = fa._kernel_variant(dtype, t, d)
    before = _k1_counts(fa.mhsa_short_backward)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.mhsa_short(*leaves, seed, h, rate).backward(g)
    torch.cuda.synchronize()
    assert _launched_wide(fa.mhsa_short_backward, before, variant)
    # No atomics: a second launch gives the same gradients to the bit.
    again = fa.mhsa_short_backward(q, k, v, g, seed, h, rate)
    for leaf, x in zip(leaves, again):
        assert torch.equal(leaf.grad, x)
    want = fa.mhsa_short_backward_reference(q, k, v, g, seed, h, rate)
    for leaf, w in zip(leaves, want):
        err = (leaf.grad.float() - w.float()).abs()
        assert leaf.grad.dtype == dtype
        assert err.max().item() <= (2e-2 if dtype == BF16 else 1e-5)
        assert err.mean().item() <= (1e-3 if dtype == BF16 else 1e-6)
    if dtype == F32:
        again = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = fa.mhsa_short_reference(*again, seed, h, rate)
        for leaf, w in zip(leaves, torch.autograd.grad(ref, again, g)):
            assert (leaf.grad - w).abs().max().item() <= 1e-5


def _shifted_eye(b, t, h, d, offset, dtype):
    """(B, T, H*D) whose head slice holds 1 at (offset + c, c): as V, the
    output's column c is the dropped weight of key offset + c; as the
    output gradient, dv's column c is that of query offset + c."""
    eye = torch.zeros(t, d, device="cuda", dtype=dtype)
    rows = torch.arange(offset, min(offset + d, t), device="cuda")
    eye[rows, rows - offset] = 1
    return eye.repeat(1, h).expand(b, t, h * d).contiguous()


def _kept_sets(run, b, t, h, d, dtype, backward=False):
    """The kept set (B, H, T, T) read off the forward's output under
    shifted-identity values, or off the backward's dv under a
    shifted-identity output gradient (``backward``), in two pieces (keys,
    or queries, from 0 and from T - D): T may be up to 2 D."""
    kept = torch.zeros(b, h, t, t, dtype=torch.bool, device="cuda")
    for offset in (0, max(t - d, 0)):
        span = min(d, t - offset)
        read = run(_shifted_eye(b, t, h, d, offset, dtype)).reshape(
            b, t, h, d)[..., :span].permute(0, 2, 1, 3) > 0
        if backward:
            kept[..., offset:offset + span, :] = read.transpose(-1, -2)
        else:
            kept[..., offset:offset + span] = read
    return kept


@pytest.mark.parametrize("b,t,h,d,dtype", [
    (8, 65, 16, 64, BF16), (3, 128, 4, 64, BF16), (2, 97, 3, 64, F32),
    (3, 100, 2, 64, F32)])
def test_mhsa_short_wide_kernels_draw_the_plain_versions_mask(cuda, b, t, h,
                                                              d, dtype):
    """The kept set of the forward and of the backward is the bit
    function's of absolute (seed, frame, head, query, key), whatever the
    padding and the warps of the wide instantiation; another seed draws
    another."""
    rate = 0.3
    q, k = _qkv(b, t, h * d, dtype, seed=t)[:2]
    with torch.no_grad():
        fwd = lambda seed: lambda eye: fa.mhsa_short(  # noqa: E731
            q, k, eye, seed, h, rate if seed else 0.0)
        kept = _kept_sets(fwd(4242), b, t, h, d, dtype)
        kept_bwd = _kept_sets(lambda eye: fa.mhsa_short_backward(
            q, k, eye, eye, 4242, h, rate)[2], b, t, h, d, dtype,
            backward=True)
        positive = _kept_sets(fwd(None), b, t, h, d, dtype)
        other = _kept_sets(fwd(4243), b, t, h, d, dtype)
    bits = prng.dropout_bits(4242, b, h, t, t, device="cuda")
    want = prng.keep_mask(bits, rate) & positive
    assert torch.equal(kept, want)
    assert torch.equal(kept_bwd, want)
    assert not torch.equal(kept, other)


@pytest.mark.parametrize("variant,dtype", [("tc", BF16), ("scalar", F32)])
def test_mhsa_short_both_instantiations_draw_one_mask(cuda, variant, dtype):
    """The wide entries take T <= 64 as well: there they give the T <= 64
    kernels' kept set (the mask does not depend on the instantiation) and
    their values within the tolerance."""
    b, t, h, d, rate, seed = 4, 50, 4, 64, 0.3, 11
    q, k = _qkv(b, t, h * d, dtype, seed=5)[:2]
    eye = _shifted_eye(b, t, h, d, 0, dtype)
    narrow, wide = fa.load_library()[variant][0], fa._entries[
        variant + "_wide"][0]
    outs = []
    for entry in (narrow, wide):
        out = torch.empty_like(q)
        err = entry(q.data_ptr(), k.data_ptr(), eye.data_ptr(),
                    out.data_ptr(), b, t, h, d, int(dtype == BF16), seed,
                    rate, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0] > 0, outs[1] > 0)
    tol = 2e-2 if dtype == BF16 else 1e-5
    assert (outs[0].float() - outs[1].float()).abs().max().item() <= tol


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


# Each instantiation of the forward (``ln.forward_variant``), at row counts
# that are no multiple of the rows a warp takes at a time (4 at d = 512
# bf16, 2 at 1,024 or 512 f32): 1, 3, 401, 76,401.
@pytest.mark.parametrize("rows", [1, 3, 401, 76401])
@pytest.mark.parametrize("d,dtype,variant", [
    (512, BF16, "bfloat16/512"),
    (1024, BF16, "bfloat16/1024"),
    (512, F32, "float32/512"),
    (1024, F32, "float32/1024"),
    (768, BF16, "bfloat16/vector"),
    (768, F32, "float32/vector"),
    (100, BF16, "bfloat16/scalar"),   # 200 bytes: off the 16-byte grid
    (30, F32, "float32/scalar"),
])
def test_layer_norm_forward_variants_match_plain_version(cuda, rows, d,
                                                         dtype, variant):
    x, scale, bias, _ = _ln_inputs(rows, d, dtype, seed=rows + d)
    before = dict(ln.layer_norm.variant_launches)
    with torch.no_grad():
        got = ln.layer_norm(x, scale, bias, 1e-5)
        torch.cuda.synchronize()
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
    moved = {k: v - before[k] for k, v in ln.layer_norm.variant_launches.items()
             if v != before[k]}
    assert moved == {variant: 1}
    if dtype == BF16:
        assert _within_one_bf16_ulp(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,variant", [(BF16, "bfloat16/scalar"),
                                           (F32, "float32/scalar")])
def test_layer_norm_forward_of_an_unaligned_view(cuda, dtype, variant):
    """A view that starts one element in is off the 16-byte boundary: the
    scalar instantiation takes it, whatever its width."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    flat = torch.randn(401 * 512 + 1, generator=gen, device="cuda")
    x = (flat * 2.0 + 0.5).to(dtype)[1:].view(401, 512)
    scale = 1.0 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(512, generator=gen, device="cuda")
    before = ln.layer_norm.variant_launches[variant]
    with torch.no_grad():
        got = ln.layer_norm(x, scale, bias, 1e-5)
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
    assert ln.layer_norm.variant_launches[variant] == before + 1
    if dtype == BF16:
        assert _within_one_bf16_ulp(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-5


def _assert_backward_close(got, want, dtype):
    """dx within one bf16 ulp (1e-5 at float32); dscale and dbias, sums
    over the rows in another order, within 1e-4 of their largest entry."""
    if dtype == BF16:
        assert _within_one_bf16_ulp(got[0], want[0])
    else:
        assert (got[0] - want[0]).abs().max().item() <= 1e-5
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == F32 and a.shape == w.shape
        assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-4


# Each instantiation of the backward (``ln.backward_variant``), at row counts
# that are no multiple of the rows a warp takes at a time (4 at d = 512
# bf16, 2 at 1,024 bf16 or 512 f32) nor of the rows a block owns.
@pytest.mark.parametrize("rows", [1, 3, 401, 76401])
@pytest.mark.parametrize("d,dtype,variant", [
    (512, BF16, "bfloat16/512"),
    (1024, BF16, "bfloat16/1024"),
    (512, F32, "float32/512"),
    (1024, F32, "float32/1024"),
    (768, BF16, "bfloat16/vector"),
    (768, F32, "float32/vector"),
    (100, BF16, "bfloat16/scalar"),   # 200 bytes: off the 16-byte grid
    (30, F32, "float32/scalar"),
])
def test_layer_norm_backward_variants_match_plain_version(cuda, rows, d,
                                                          dtype, variant):
    x, scale, _, g = _ln_inputs(rows, d, dtype, seed=rows + d + 1)
    before = dict(ln.layer_norm_backward.variant_launches)
    got = ln.layer_norm_backward(x, scale, g, 1e-5)
    torch.cuda.synchronize()
    moved = {k: v - before[k]
             for k, v in ln.layer_norm_backward.variant_launches.items()
             if v != before[k]}
    assert moved == {variant: 1}
    _assert_backward_close(got, ln.layer_norm_backward_plain(x, scale, g,
                                                             1e-5), dtype)


@pytest.mark.parametrize("dtype,variant", [(BF16, "bfloat16/scalar"),
                                           (F32, "float32/scalar")])
@pytest.mark.parametrize("unaligned", ["x", "g"])
def test_layer_norm_backward_of_an_unaligned_view(cuda, dtype, variant,
                                                  unaligned):
    """x or g a view that starts one element in: the scalar instantiation
    takes it, whatever its width."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    flat = torch.randn(2, 401 * 512 + 1, generator=gen, device="cuda")
    views = [(t * 2.0 + 0.5).to(dtype)[1:].view(401, 512) for t in flat]
    x, g = _ln_inputs(401, 512, dtype, seed=13)[::3]
    x, g = (views[0], g) if unaligned == "x" else (x, views[1])
    scale = 1.0 + 0.1 * torch.randn(512, generator=gen, device="cuda")
    before = ln.layer_norm_backward.variant_launches[variant]
    got = ln.layer_norm_backward(x, scale, g, 1e-5)
    assert ln.layer_norm_backward.variant_launches[variant] == before + 1
    _assert_backward_close(got, ln.layer_norm_backward_plain(x, scale, g,
                                                             1e-5), dtype)


@pytest.mark.parametrize("rows,d", [(5000, 512), (76401, 1024)])
def test_layer_norm_backward_parameter_sums_repeat_exactly(cuda, rows, d):
    """Partials a block, summed in a fixed order, no atomics: dscale and
    dbias (and dx) are the same bits in every run."""
    x, scale, _, g = _ln_inputs(rows, d, BF16, seed=rows)
    first = ln.layer_norm_backward(x, scale, g, 1e-5)
    second = ln.layer_norm_backward(x, scale, g, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[1].data_ptr() + 4 * d == first[2].data_ptr()



@pytest.mark.parametrize("d,dtype", [(1024, F32), (512, BF16)])
def test_layer_norm_backward_on_a_second_card(cuda, d, dtype):
    """The backward's launch plan (the SMs, the blocks an SM holds, the
    shared memory it opts in to: 64 KB a block at 1,024 float32) is asked
    of the card that holds x: card 1 after card 0 at the same shape, then
    card 0 again, each against the plain version; cards of one model give
    the same bits."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    inputs = _ln_inputs(5000, d, dtype, seed=d + 7)
    results = []
    for card in ("cuda:0", "cuda:1", "cuda:0"):
        x, scale, _, g = (t.to(card) for t in inputs)
        got = ln.layer_norm_backward(x, scale, g, 1e-5)
        _assert_backward_close(got, ln.layer_norm_backward_plain(
            x, scale, g, 1e-5), dtype)
        results.append([t.cpu() for t in got])
    if torch.cuda.get_device_name(0) == torch.cuda.get_device_name(1):
        assert all(torch.equal(a, b) for a, b in zip(*results[:2]))

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


# A thread's span of an iteration is 4 16-byte units (32 bf16, 16 float32
# elements), a block's 256 of those: tails of 1-17 elements past three
# blocks' spans take the partial span and the scalar tail.
@pytest.mark.parametrize("tail", range(1, 18))
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_hw_dropout_kernel_at_every_tail(cuda, tail, dtype):
    n = 3 * 256 * 4 * 8 + tail
    gen = torch.Generator(device="cuda").manual_seed(tail)
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    x[x == 0] = 1.0
    got = dr.hw_dropout(x, 1234, 0.1)
    want = dr.hw_dropout_plain(x, 1234, 0.1)
    assert torch.equal(got, want) and torch.equal(got != 0, want != 0)


# Views that start 1-7 elements into a tensor: unaligned for the 16-byte
# accesses (but float32 at 4), masked by their own flat index.
@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_hw_dropout_kernel_at_every_offset(cuda, offset, dtype):
    gen = torch.Generator(device="cuda").manual_seed(100 + offset)
    base = torch.randn(50001, generator=gen, device="cuda").to(dtype)
    base[base == 0] = 1.0
    x = base[offset:offset + 40000]
    got = dr.hw_dropout(x, 99, 0.1)
    want = dr.hw_dropout_plain(x, 99, 0.1)
    assert torch.equal(got, want) and torch.equal(got != 0, want != 0)


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


# ---- K3: flash attention ----

def _flash_inputs(b, t, s, h, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(b, t, h, d), (b, s, h, d), (b, s, h, d), (b, t, h, d)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in shapes]


def _flash_mask(kind, t, s):
    """None, a BandMask, or a random (T, S) bool tensor that admits
    col == min(row, S - 1) in every row."""
    if kind == "none":
        return None
    if kind == "causal":
        return fl.BandMask(t, s)
    if kind == "band":
        return fl.BandMask(t, s, 10)
    gen = torch.Generator(device="cuda").manual_seed(t * 1000 + s)
    mask = torch.rand((t, s), generator=gen, device="cuda") < 0.4
    rows = torch.arange(t, device="cuda")
    mask[rows, rows.clamp_max(s - 1)] = True
    return mask


def _flash_close(got, want, dtype, rounding=0.0):
    """float32: 2e-5 of the tensor's largest entry (sums over 256 columns
    and up to 191 keys in another order). bf16: one unit in the last place
    of bf16 at the value's magnitude (the one rounding of the output may
    fall to the other side) plus that; or, for the tc variant, plus
    ``rounding`` of the largest entry instead: the tensor cores take P and
    ds rounded to bf16 where the plain versions keep float32 (2^-9 for the
    forward, 2^-7 for the gradients)."""
    w = want.float()
    scale = w.abs().max().item()
    tol = rounding * scale if rounding else 2e-5 * max(1.0, scale)
    err = (got.float() - w).abs()
    if dtype == BF16:
        exponent = torch.frexp(w.abs().clamp_min(1e-30))[1]
        err = err - torch.ldexp(torch.ones_like(w), exponent - 8)
    return err.max().item() <= tol


FWD_ROUNDING, GRAD_ROUNDING = 2.0 ** -9, 2.0 ** -7


FLASH_CASES = [
    (8, 191, 191, 4, 256, BF16, "causal", 0.0),   # the decoder's self-attn
    (8, 191, 191, 4, 256, BF16, "band", 0.1),     # its cross-attention
    (8, 191, 191, 4, 256, F32, "causal", 0.1),
    (2, 47, 47, 4, 256, BF16, "band", 0.0),
    (2, 33, 70, 2, 16, F32, "random", 0.3),       # T != S, the tiny width
    (3, 70, 33, 2, 64, BF16, "random", 0.0),
    (2, 50, 50, 3, 40, F32, "none", 0.25),        # D off the lane grid
    (1, 5, 7, 1, 8, F32, "causal", 0.0),
    # The tc variant: D 16, 64 and 256 (and 48, 80, 144 between buckets),
    # T and S of 1, 15, 16, 17, 47 and 191, every mask mode, both rates.
    (8, 191, 191, 4, 256, BF16, "causal", 0.1),
    (2, 191, 47, 2, 256, BF16, "none", 0.1),
    (3, 17, 191, 2, 256, BF16, "random", 0.1),
    (6, 16, 47, 2, 256, BF16, "band", 0.0),
    (4, 16, 15, 2, 64, BF16, "causal", 0.1),
    (5, 1, 17, 4, 64, BF16, "none", 0.0),
    (2, 191, 16, 1, 64, BF16, "random", 0.1),
    (2, 47, 191, 2, 16, BF16, "band", 0.1),
    (2, 17, 16, 3, 16, BF16, "random", 0.0),
    (4, 47, 17, 2, 16, BF16, "causal", 0.1),
    (3, 1, 1, 2, 16, BF16, "none", 0.1),
    (2, 15, 191, 2, 48, BF16, "none", 0.0),
    (2, 33, 47, 2, 80, BF16, "causal", 0.1),
    (1, 17, 17, 2, 144, BF16, "band", 0.1),
]


@pytest.mark.parametrize("b,t,s,h,d,dtype,kind,rate", FLASH_CASES)
def test_flash_attention_kernels_match_plain_versions(cuda, b, t, s, h, d,
                                                      dtype, kind, rate):
    q, k, v, g = _flash_inputs(b, t, s, h, d, dtype, seed=b * 100 + t)
    mask = _flash_mask(kind, t, s)
    seed = 321 if rate else None
    variant = fl._kernel_variant(dtype, d)
    assert variant == ("tc" if dtype == BF16 and d % 16 == 0 else "scalar")
    counted = (fl.flash_attention, fl.flash_attention_dq,
               fl.flash_attention_dkv)
    marks = [(c.launches, c.tc_launches) for c in counted]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fl.flash_attention(*leaves, mask, seed, rate)
    # A non-contiguous gradient, as autograd may hand over.
    out.backward(g.transpose(0, 1).contiguous().transpose(0, 1))
    torch.cuda.synchronize()
    for c, mark in zip(counted, marks):
        assert _launched(c, mark, variant)
    with torch.no_grad():
        want, want_lse = fl.flash_attention_reference(q, k, v, mask, seed,
                                                      rate)
        got, lse = fl.flash_attention_forward(q, k, v, mask, seed, rate)
        assert torch.equal(got, out)
        assert (lse - want_lse).abs().max().item() <= 1e-4
        grads = fl.flash_attention_backward_reference(
            q, k, v, mask, seed, got, lse, g, rate)
    tc = variant == "tc"
    assert out.dtype == dtype and out.shape == q.shape
    assert _flash_close(out, want, dtype, FWD_ROUNDING if tc else 0.0)
    for leaf, w in zip(leaves, grads):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        assert _flash_close(leaf.grad, w, dtype, GRAD_ROUNDING if tc else 0.0)
    if dtype == F32:
        # And against autograd through the plain forward (same mask).
        again = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = fl.flash_attention_reference(*again, mask, seed, rate)[0]
        for leaf, w in zip(leaves, torch.autograd.grad(ref, again, g)):
            assert _flash_close(leaf.grad, w, dtype)


@pytest.mark.parametrize("window", [None, 10, 1, 40])
def test_flash_attention_index_mask_equals_the_tensor_mask(cuda, window):
    """The mask computed from indices, with its skipped tiles, against the
    same mask read from a tensor, every tile visited: equal bits (the
    skipped tiles hold only exp(-1e30 - m) = 0)."""
    q, k, v, g = _flash_inputs(2, 191, 191, 4, 256, BF16, seed=5)
    band = fl.BandMask(191, 191, window)
    results = []
    for mask in (band, band.tensor("cuda")):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fl.flash_attention(*leaves, mask, 77, 0.1)
        out.backward(g)
        results.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_kernels_draw_one_mask(cuda, dtype):
    """With V = [I | 0] per head the output is the dropped weights, and
    with g = [I | 0] dv is their transpose: the forward's and the dK/dV
    kernel's kept sets are read off and must be the bit function's; a
    batch prefix draws the prefix's bits; another seed another mask. float32
    runs the scalar kernels, bf16 the tc ones."""
    b, t, h, d, rate = 4, 191, 4, 256, 0.1
    q, k, _, _ = _flash_inputs(b, t, t, h, d, dtype, seed=9)
    eye = torch.eye(t, d, device="cuda", dtype=dtype).view(1, t, 1, d).expand(
        b, t, h, d).contiguous()
    marks = (fl.flash_attention.tc_launches,
             fl.flash_attention_dkv.tc_launches)
    with torch.no_grad():
        clean, lse = fl.flash_attention_forward(q, k, eye)
        out, lse_d = fl.flash_attention_forward(q, k, eye, None, 11, rate)
        other = fl.flash_attention_forward(q, k, eye, None, 12, rate)[0]
        want = fl.flash_attention_reference(q, k, eye, None, 11, rate)[0]
        _, _, dv = fl.flash_attention_backward(q, k, eye, None, 11, out,
                                               lse_d, eye, rate)
        prefix = fl.flash_attention_forward(q[:2], k[:2], eye[:2], None, 11,
                                            rate)[0]
    tc = 1 if dtype == BF16 else 0
    assert (fl.flash_attention.tc_launches,
            fl.flash_attention_dkv.tc_launches) == (marks[0] + 4 * tc,
                                                    marks[1] + tc)
    assert torch.equal(lse, lse_d)       # the denominator sums undropped p
    positive = clean[..., :t].permute(0, 2, 1, 3) > 0      # (B, H, T, S)
    kept = out[..., :t].permute(0, 2, 1, 3) > 0
    keep = prng.keep_mask(prng.dropout_bits(
        11, b, h, t, t, device="cuda", key_word=prng.FLASH_KEY_WORD), rate)
    assert torch.equal(kept, keep & positive)
    assert torch.equal(kept, want[..., :t].permute(0, 2, 1, 3) > 0)
    kept_bwd = dv[..., :t].permute(0, 2, 3, 1) > 0         # dv is (B,S,H,T)
    assert torch.equal(kept_bwd, kept)
    assert torch.equal(prefix, out[:2])
    assert not torch.equal(out > 0, other > 0)
    share = 1.0 - (kept & positive).sum().item() / positive.sum().item()
    assert abs(share - rate) <= 4 * (0.09 / positive.sum().item()) ** 0.5


@pytest.mark.parametrize("b,t,h,d,kind", [
    (8, 191, 4, 256, "causal"),     # the decoder's self-attention
    (6, 50, 16, 64, "none"),        # the ViT's attention under "pallas"
    (3, 47, 2, 16, "random"),
])
def test_flash_attention_gradients_repeat_exactly(cuda, b, t, h, d, kind):
    """Every output element has one owner and nothing is summed with
    atomics: two backward calls of the tc variant give the same bits."""
    q, k, v, g = _flash_inputs(b, t, t, h, d, BF16, seed=4)
    mask = _flash_mask(kind, t, t)
    marks = (fl.flash_attention_dq.tc_launches,
             fl.flash_attention_dkv.tc_launches)
    with torch.no_grad():
        out, lse = fl.flash_attention_forward(q, k, v, mask, 3, 0.1)
        first = fl.flash_attention_backward(q, k, v, mask, 3, out, lse, g, 0.1)
        second = fl.flash_attention_backward(q, k, v, mask, 3, out, lse, g,
                                             0.1)
    assert (fl.flash_attention_dq.tc_launches,
            fl.flash_attention_dkv.tc_launches) == (marks[0] + 2,
                                                    marks[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _flash_inputs(2, 9, 9, 2, 16, F32, seed=0)
    with torch.no_grad():
        with pytest.raises(TypeError):
            fl.flash_attention(q.half(), k.half(), v.half())
        with pytest.raises(ValueError, match="contiguous"):
            fl.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
        with pytest.raises(ValueError, match="D <= 256"):
            fl.flash_attention(*_flash_inputs(1, 4, 4, 1, 320, F32, 1)[:3])
        with pytest.raises(ValueError, match="BandMask of"):
            fl.flash_attention(q, k, v, fl.BandMask(9, 8))
        with pytest.raises(ValueError, match="bool mask"):
            fl.flash_attention(q, k, v, torch.ones(9, 9, device="cuda"))
        with pytest.raises(ValueError, match="explicit int32 seed"):
            fl.flash_attention(q, k, v, None, None, 0.1)
        assert fl.flash_attention(q[:0], k[:0], v[:0]).shape == (0, 9, 2, 16)


# ---- the fused ViT sub-block kernels (csrc/fused_block.cu) ----

def _block_params(d, f, inner, seed):
    """x-independent parameters as the model hands them over: each weight
    the (in, out) view of a matrix stored (out, in)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    lin = lambda i, o: (randn(o, i) * i ** -0.5).t()  # noqa: E731
    vec = lambda n: randn(n) * 0.3  # noqa: E731
    mlp = (lin(d, f), vec(f), lin(f, d), vec(d), 1 + vec(d) * 0.3, vec(d))
    attn = (lin(d, inner), lin(d, inner), lin(d, inner), lin(inner, d),
            vec(d), 1 + vec(d) * 0.3, vec(d))
    return mlp, attn


def _block_inputs(b, t, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2)]


def _assert_block_close(got, want, dtype, what):
    """float32: 2e-5 of the tensor's largest entry (sums in another order).
    bf16: both versions round at the same places, so an output is within
    one or two bf16 ulps (2^-7 relative) of the other's and a parameter
    gradient, a sum of many such products, within 1e-2 of its largest
    entry."""
    tol = 2e-5 if dtype == F32 else 1.6e-2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        scale = max(w.float().abs().max().item(), 1e-30)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (what, i, err, scale)


BLOCK_SHAPES = [
    # b, t, d, f, heads, head_dim
    (8, 50, 512, 512, 16, 64),     # the flagship ViT, one served tick
    (1, 50, 512, 512, 16, 64),     # CAD encode
    (3, 13, 64, 48, 2, 8),         # T < 32, narrow heads, ragged F
    (2, 64, 192, 100, 3, 64),      # T at the kernels' limit
    (5, 33, 96, 130, 3, 24),       # nothing a multiple of the tiles
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,f,heads,head_dim", BLOCK_SHAPES)
def test_fused_block_kernels_match_their_plain_versions(cuda, b, t, d, f,
                                                        heads, head_dim,
                                                        rate, dtype):
    mlp, attn = _block_params(d, f, heads * head_dim, seed=b * 100 + t)
    x, gy = _block_inputs(b, t, d, dtype, seed=t)
    seed = 4242 if rate else None
    counts = lambda: (fb.mlp_block.launches, fb.mlp_block_backward.launches,  # noqa: E731
                      fb.attn_block.launches, fb.attn_block_backward.launches)
    before = counts()
    with torch.no_grad():
        y = fb.mlp_block(x, *mlp, seed, rate)
        grads = fb.mlp_block_backward(x, *mlp, gy, seed, rate)
        ya = fb.attn_block(x, *attn, seed, heads, rate)
        grads_a = fb.attn_block_backward(x, *attn, gy, seed, heads, rate)
        torch.cuda.synchronize()
        assert counts() == tuple(c + 1 for c in before)
        _assert_block_close([y], [fb.mlp_block_reference(x, *mlp, seed, rate)],
                            dtype, "mlp forward")
        _assert_block_close(grads, fb.mlp_block_backward_reference(
            x, *mlp, gy, seed, rate), dtype, "mlp backward")
        _assert_block_close([ya], [fb.attn_block_reference(
            x, *attn, seed, heads, rate)], dtype, "attn forward")
        _assert_block_close(grads_a, fb.attn_block_backward_reference(
            x, *attn, gy, seed, heads, rate), dtype, "attn backward")
    assert grads[0].dtype == dtype and grads[1].dtype == F32


@pytest.mark.parametrize("op", ["mlp", "attn"])
def test_fused_block_kernels_draw_the_plain_versions_masks(cuda, op):
    """The residual branch's kept set is read off y - x; the inner site's
    (hidden layer, attention weights) shows in the values, which must agree
    with the plain version's and differ under another seed."""
    b, t, d, f, heads = 4, 50, 128, 256, 2
    mlp, attn = _block_params(d, f, heads * 64, seed=1)
    x, _ = _block_inputs(b, t, d, F32, seed=2)
    rate = 0.3
    with torch.no_grad():
        if op == "mlp":
            run = lambda fn, seed: fn(x, *mlp, seed, rate)  # noqa: E731
            got, want = run(fb.mlp_block, 9), run(fb.mlp_block_reference, 9)
            other = run(fb.mlp_block, 10)
        else:
            run = lambda fn, seed: fn(x, *attn, seed, heads, rate)  # noqa: E731
            got, want = run(fb.attn_block, 9), run(fb.attn_block_reference, 9)
            other = run(fb.attn_block, 10)
    assert torch.equal(got - x != 0, want - x != 0)
    share = (got - x == 0).float().mean().item()
    assert abs(share - rate) < 0.02
    _assert_block_close([got], [want], F32, op)
    assert not torch.equal(got - x != 0, other - x != 0)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fused_block_gradients_under_autograd_and_bit_equal_repeats(cuda,
                                                                    dtype):
    """Through the autograd Functions, as the model calls them; float32
    gradients also against autograd through the plain forward (1e-4 of the
    largest entry); two runs give the same bits (no atomics)."""
    b, t, d, f, heads = 6, 50, 512, 512, 16
    mlp, attn = _block_params(d, f, heads * 64, seed=3)
    x, gy = _block_inputs(b, t, d, dtype, seed=4)

    def grads_of(fn_mlp, fn_attn):
        leaves = [p.detach().clone().requires_grad_()
                  for p in (x,) + mlp + attn]
        xx, m, a = leaves[0], leaves[1:7], leaves[7:]
        y = fn_mlp(fn_attn(xx, *a, 77, heads, 0.1), *m, 78, 0.1)
        return torch.autograd.grad(y, leaves, gy)

    first = grads_of(fb.mlp_block, fb.attn_block)
    second = grads_of(fb.mlp_block, fb.attn_block)
    torch.cuda.synchronize()
    for i, (g1, g2) in enumerate(zip(first, second)):
        assert torch.equal(g1, g2), f"gradient {i} differs between two runs"
    if dtype == F32:
        want = grads_of(fb.mlp_block_reference, fb.attn_block_reference)
        for i, (g, w) in enumerate(zip(first, want)):
            err = (g - w).abs().max().item()
            assert err <= 1e-4 * w.abs().max().item(), (i, err)


def test_fused_block_kernels_refuse_what_they_do_not_take(cuda):
    mlp, attn = _block_params(64, 64, 64, seed=5)
    x, _ = _block_inputs(2, 10, 64, F32, seed=6)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fb.mlp_block(x.half(), *mlp, None)
        with pytest.raises(ValueError, match="contiguous"):
            fb.mlp_block(x.transpose(0, 1).contiguous().transpose(0, 1),
                         *mlp, None)
        wide_mlp, wide_attn = _block_params(576, 64, 64, seed=7)
        wide = torch.zeros(1, 4, 576, device="cuda")
        with pytest.raises(ValueError, match="D <= 512"):
            fb.mlp_block(wide, *wide_mlp, None)
        with pytest.raises(ValueError, match="D <= 512"):
            fb.attn_block(wide, *wide_attn, None, 1)
        long = torch.zeros(1, 65, 64, device="cuda")
        with pytest.raises(ValueError, match="T <= 64"):
            fb.attn_block(long, *attn, None, 1)
        # The MLP kernels take any T: their blocks own rows, not frames.
        assert fb.mlp_block(long, *mlp, None).shape == long.shape
        _, fat = _block_params(64, 64, 128, seed=8)
        with pytest.raises(ValueError, match="heads of at most 64"):
            fb.attn_block(x, *fat, None, 1)


# The attention sub-block's tc variant (bf16, heads of 64, D a multiple of
# 64): every shape here takes it.
TC_BLOCK_SHAPES = [
    # b, t, d, heads
    (1, 50, 512, 16),     # the flagship ViT: CAD encode
    (8, 50, 512, 16),     # one served tick
    (64, 50, 512, 16),
    (8, 64, 512, 16),     # T at a block's 64 rows, no padding
    (3, 17, 192, 3),      # one row past a 16-row tile; D not a multiple of 128
    (5, 33, 128, 2),
    (2, 1, 64, 1),        # one token
]


def _assert_tc_close(got, want, what):
    """bf16 outputs (y, dx): within two bf16 ulps of the largest entry, a
    share of 2^-6 (chip_smoke.py:block_close): both versions round at the
    same places, and a sum taken in another order can flip a rounding.
    Parameter gradients (float32 sums over every token): 1% of their
    largest entry. A flipped rounding of one dq, dk or dv entry moves every
    entry of its weight gradient's column by an ulp of it times an h entry,
    which over the few hundred tokens of these shapes reaches half a
    percent of the largest entry, for the present kernels ("tile") as for
    the tc variant."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        share = 2.0 ** -6 if g.dtype == BF16 else 1e-2
        scale = max(w.float().abs().max().item(), 1e-30)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= share * scale, (what, i, err, scale)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,heads", TC_BLOCK_SHAPES)
def test_attn_block_tc_variant_matches_the_plain_versions(cuda, b, t, d,
                                                          heads, rate):
    """Forward and every gradient against the plain versions; the tc
    counters move; the gradients repeat bit for bit."""
    _, attn = _block_params(d, 64, heads * 64, seed=b * 10 + t)
    x, gy = _block_inputs(b, t, d, BF16, seed=t + 1)
    seed = 5151 if rate else None
    assert fb._attn_variant(BF16, t, d, 64) == "tc"
    marks = (fb.attn_block.tc_launches, fb.attn_block_backward.tc_launches)
    with torch.no_grad():
        y = fb.attn_block(x, *attn, seed, heads, rate)
        grads = fb.attn_block_backward(x, *attn, gy, seed, heads, rate)
        again = fb.attn_block_backward(x, *attn, gy, seed, heads, rate)
        torch.cuda.synchronize()
        assert (fb.attn_block.tc_launches,
                fb.attn_block_backward.tc_launches) == (marks[0] + 1,
                                                        marks[1] + 2)
        _assert_tc_close([y], [fb.attn_block_reference(
            x, *attn, seed, heads, rate)], "forward")
        _assert_tc_close(grads, fb.attn_block_backward_reference(
            x, *attn, gy, seed, heads, rate), "backward")
    for i, (g1, g2) in enumerate(zip(grads, again)):
        assert torch.equal(g1, g2), f"gradient {i} differs between two runs"


def test_attn_block_tc_variant_draws_the_plain_versions_sets(cuda):
    """The kept sets of sites 1 and 0 at the flagship's widths, read off the
    outputs under constructed parameters (as chip_smoke.py's
    block_kept_sets): identical to the plain version's and to the bit
    function's."""
    b, t, d, heads, hd, rate, seed = 8, 50, 512, 16, 64, 0.1, 77
    _, attn = _block_params(d, 64, heads * hd, seed=9)
    keep = lambda site, h, rows, cols: prng.keep_mask(  # noqa: E731
        prng.block_site_bits(seed, site, b, h, rows, cols, device="cuda"),
        rate)
    keep_res = keep(prng.SITE_ATTN_RES, 1, t, d)[:, 0]
    with torch.no_grad():
        # Site 1: x = 0 and a bias of 50 make the output the dropped branch,
        # non-zero exactly where it was kept.
        zero = torch.zeros((b, t, d), device="cuda", dtype=BF16)
        biased = attn[:4] + (torch.full((d,), 50.0, device="cuda"),) + attn[5:]
        got = fb.attn_block(zero, *biased, seed, heads, rate) != 0
        want = fb.attn_block_reference(zero, *biased, seed, heads, rate) != 0
        assert torch.equal(got, want) and torch.equal(got, keep_res)
        # Site 0: token j is the one-hot e_j; Wq = Wk = 0 make every weight
        # 1 / T, Wv puts 1 / rstd at (j, head column j), so head output row i
        # is about kept_ij / (T (1 - rate)) at column j; Wo copies 8 heads a
        # call into the 512 output columns, times 16.
        x = torch.zeros((b, t, d), device="cuda", dtype=BF16)
        rows = torch.arange(t, device="cuda")
        x[:, rows, rows] = 1.0
        rstd = (1.0 / d * (1.0 - 1.0 / d) + 1e-5) ** -0.5
        wv = torch.zeros((heads * hd, d), device="cuda")
        wv.view(heads, hd, d)[:, rows, rows] = 1.0 / rstd
        nothing = torch.zeros((heads * hd, d), device="cuda").t()
        ones, zeros = torch.ones(d, device="cuda"), torch.zeros(d,
                                                                device="cuda")
        keep_w = keep(prng.SITE_ATTN_W, heads, t, t)
        level = 16.0 / (t * (1.0 - rate))
        cols = torch.arange(hd, device="cuda")
        slots = torch.arange(heads // 2, device="cuda")
        for first in (0, heads // 2):
            wo = torch.zeros((d, heads * hd), device="cuda")
            wo.view(heads // 2, hd, heads, hd)[
                slots[:, None], cols[None, :], first + slots[:, None],
                cols[None, :]] = 16.0
            args = (nothing, nothing, wv.t(), wo.t(), zeros, ones, zeros)
            got = fb.attn_block(x, *args, seed, heads, rate).float() - x.float()
            want = fb.attn_block_reference(x, *args, seed, heads,
                                           rate).float() - x.float()
            kept = got.view(b, t, heads // 2, hd)[..., :t] > level / 2
            plain = want.view(b, t, heads // 2, hd)[..., :t] > level / 2
            bits = (keep_w[:, first:first + heads // 2].permute(0, 2, 1, 3)
                    & keep_res.view(b, t, heads // 2, hd)[..., :t])
            assert torch.equal(kept, plain) and torch.equal(kept, bits)


# The MLP sub-block's tc variant (bf16, D and F multiples of 64, D up to
# 512): every shape here takes it; row counts that are not multiples of a
# tile's 64 rows.
TC_MLP_SHAPES = [
    # b, t, d, f
    (1, 50, 512, 512),    # the flagship ViT: CAD encode
    (8, 50, 512, 512),    # one served tick: 400 rows
    (3, 7, 512, 512),     # 21 rows
    (64, 50, 512, 512),   # 3,200 rows, 50 blocks
    (3, 7, 128, 192),     # narrower, F not a multiple of 128
    (5, 33, 192, 64),     # D not a multiple of 128, the narrowest F
    (2, 25, 256, 1024),   # F wider than D
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,d,f", TC_MLP_SHAPES)
def test_mlp_block_tc_variant_matches_the_plain_versions(cuda, b, t, d, f,
                                                         rate):
    """Forward and every gradient against the plain versions and against
    the present kernels ("tile") on the same inputs; the tc counters move;
    the gradients repeat bit for bit."""
    mlp, _ = _block_params(d, f, 64, seed=b * 10 + t + f)
    x, gy = _block_inputs(b, t, d, BF16, seed=t + 2)
    seed = 6161 if rate else None
    assert fb._mlp_variant(BF16, d, f) == "tc"
    marks = (fb.mlp_block.tc_launches, fb.mlp_block_backward.tc_launches)
    with torch.no_grad():
        y = fb.mlp_block(x, *mlp, seed, rate)
        grads = fb.mlp_block_backward(x, *mlp, gy, seed, rate)
        again = fb.mlp_block_backward(x, *mlp, gy, seed, rate)
        torch.cuda.synchronize()
        assert (fb.mlp_block.tc_launches,
                fb.mlp_block_backward.tc_launches) == (marks[0] + 1,
                                                       marks[1] + 2)
        _assert_tc_close([y], [fb.mlp_block_reference(x, *mlp, seed, rate)],
                         "forward")
        _assert_tc_close(grads, fb.mlp_block_backward_reference(
            x, *mlp, gy, seed, rate), "backward")
        _assert_tc_close([y], [fb._mlp_forward(
            x, *mlp, seed, rate, 1e-5, variant="tile")], "forward vs tile")
        _assert_tc_close(grads, fb._mlp_backward(
            x, *mlp, gy, seed, rate, 1e-5, variant="tile"),
            "backward vs tile")
    for i, (g1, g2) in enumerate(zip(grads, again)):
        assert torch.equal(g1, g2), f"gradient {i} differs between two runs"


def test_mlp_block_tc_variant_draws_the_plain_versions_sets(cuda):
    """The kept sets of sites 3 and 2 at the flagship's widths, read off
    the outputs under constructed parameters (as chip_smoke.py's
    block_kept_sets), over 400 rows whose 64-row blocks span frames:
    identical to the plain version's and to the bit function's."""
    b, t, d, f, rate, seed = 8, 50, 512, 512, 0.1, 88
    mlp, _ = _block_params(d, f, 64, seed=10)
    keep = lambda site, cols: prng.keep_mask(  # noqa: E731
        prng.block_site_bits(seed, site, b, 1, t, cols, device="cuda"),
        rate)[:, 0]
    zero = torch.zeros((b, t, d), device="cuda", dtype=BF16)
    with torch.no_grad():
        # Site 3: x = 0 and a bias of 50 make the output the dropped branch,
        # non-zero exactly where it was kept.
        biased = mlp[:3] + (torch.full((d,), 50.0, device="cuda"),) + mlp[4:]
        got = fb.mlp_block(zero, *biased, seed, rate) != 0
        want = fb.mlp_block_reference(zero, *biased, seed, rate) != 0
        assert torch.equal(got, want)
        assert torch.equal(got, keep(prng.SITE_MLP_RES, d))
        # Site 2: W2 = I and b2 = 0 pass the dropped hidden layer through,
        # so the output is non-zero where sites 2 and 3 both kept.
        through = (mlp[0], mlp[1], torch.eye(f, d, device="cuda"),
                   torch.zeros(d, device="cuda"), mlp[4], mlp[5])
        got = fb.mlp_block(zero, *through, seed, rate) != 0
        want = fb.mlp_block_reference(zero, *through, seed, rate) != 0
        clean = fb.mlp_block_reference(zero, *through, None, 0.0) != 0
        both = keep(prng.SITE_MLP_HID, f) & keep(prng.SITE_MLP_RES, d)
        assert torch.equal(got, want) and torch.equal(got, both & clean)


def test_block_model_train_step_on_the_card_matches_the_cpu(cuda):
    """The tiny model under "block" with dropout off, float32: one train
    step's loss and gradients on the card (kernels) against the CPU (plain
    versions), and the launch counters move by the model's depth."""
    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_train_step)

    cfg = dict(hidden_size=32, num_decoder_layers=2, dim_feedforward=32,
               nhead=2, dropout=0.0, encoder="vit", enable_past_actions=True,
               enable_past_states=True, enable_timestep_embedding=True,
               window_size=3, image_size=32, vit_patch=16, vit_dim=16,
               vit_depth=2, vit_heads=2, vit_head_dim=8, vit_mlp_dim=16,
               vit_attention_impl="block")
    data = synthetic_batch_feed(2, 6, image_size=32, seed=1)
    outs = {}
    before = (fb.attn_block.launches, fb.mlp_block_backward.launches)
    for device in ("cuda", "cpu"):
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(3))
        state = create_train_state(dict(model.named_parameters()),
                                   {"lr": 1e-5})
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        _, loss, _ = make_train_step(
            model, LossConfig(REFERENCE_CMD_WEIGHTS))(state, batch, 0)
        outs[device] = (loss.item(), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()})
    assert fb.attn_block.launches == before[0] + 4       # 2 encoders x 2
    assert fb.mlp_block_backward.launches == before[1] + 4
    assert abs(outs["cuda"][0] - outs["cpu"][0]) <= 1e-4
    for name, want in outs["cpu"][1].items():
        if name.endswith(".key.bias"):
            continue
        err = (outs["cuda"][1][name] - want).abs().max().item()
        assert err <= 1e-3 * max(want.abs().max().item(), 1e-30), name


def test_vit_attention_impl_pallas_runs_the_flash_kernels_on_the_card(cuda):
    """The tiny model with the ViT's attention through flash attention
    (vit_attention_impl "pallas"), float32: the forward launches the flash
    kernel once a ViT block of each encoder and K1 never, and its logits
    match the CPU's (plain versions)."""
    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model

    cfg = dict(hidden_size=32, num_decoder_layers=2, dim_feedforward=32,
               nhead=2, dropout=0.0, encoder="vit", enable_past_actions=True,
               enable_past_states=True, enable_timestep_embedding=True,
               window_size=3, image_size=32, vit_patch=16, vit_dim=16,
               vit_depth=2, vit_heads=2, vit_head_dim=8, vit_mlp_dim=16,
               vit_attention_impl="pallas")
    data = synthetic_batch_feed(2, 6, image_size=32, seed=2)
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(4))
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        before = (fl.flash_attention.launches, fa.mhsa_short.launches)
        with torch.no_grad():
            outs[device] = [x.cpu() for x in model(batch)]
        moved = (fl.flash_attention.launches - before[0],
                 fa.mhsa_short.launches - before[1])
        assert moved == ((2 * 2, 0) if device == "cuda" else (0, 0))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4
