"""The host path of the standalone dropout (K5), LayerNorm (K4) and fused
sub-block (K6a-d) wrappers, on the CPU: the rules that pick the LayerNorm
forward's instantiation and each sub-block's variant, the C entries the
wrappers bind against the source, and the dispatch that the lean wrappers
keep (the plain versions for a CPU tensor, no launch counted, the kernels'
input checks with their error types and messages)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from videocad_tpu_torch.ops import dropout as dr
from videocad_tpu_torch.ops import fused_block as fb
from videocad_tpu_torch.ops import layernorm as ln

BF16, F32 = torch.bfloat16, torch.float32
CSRC = Path(ln.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("d,dtype,aligned,variant", [
    (512, BF16, True, "bfloat16/512"),      # the ViT's tokens
    (1024, BF16, True, "bfloat16/1024"),    # the patch rows
    (512, F32, True, "float32/512"),
    (1024, F32, True, "float32/1024"),
    (768, BF16, True, "bfloat16/vector"),
    (8, BF16, True, "bfloat16/vector"),
    (768, F32, True, "float32/vector"),
    (100, F32, True, "float32/vector"),     # 400 bytes: on the grid
    (100, BF16, True, "bfloat16/scalar"),   # 200 bytes: off it
    (30, F32, True, "float32/scalar"),
    (1, F32, True, "float32/scalar"),
    (512, BF16, False, "bfloat16/scalar"),  # an unaligned view
    (1024, F32, False, "float32/scalar"),
])
def test_forward_variant_rule(d, dtype, aligned, variant):
    assert ln.forward_variant(d, dtype, aligned) == variant
    assert variant in ln.FWD_VARIANTS


def test_forward_variant_codes_follow_the_kernel_table():
    """FWD_VARIANTS is the order of csrc/layernorm.cu's kFwdVariants, whose
    entries name their variant in a comment: the variant code the wrapper
    passes picks that entry."""
    src = (CSRC / "layernorm.cu").read_text()
    table = src[src.index("kFwdVariants[] = {"):]
    table = table[:table.index("};")]
    named = re.findall(r"// (\d) (\w+/\w+)", table)
    assert [int(code) for code, _ in named] == list(range(8))
    assert tuple(name for _, name in named) == ln.FWD_VARIANTS


def _ln_case(rows=6, d=16):
    rng = np.random.default_rng(rows * d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    return x, scale, bias


def test_lean_wrappers_run_the_plain_versions_on_the_cpu():
    x, scale, bias = _ln_case()
    marks = (ln.layer_norm.launches, dict(ln.layer_norm.variant_launches),
             ln.layer_norm_backward.launches, dr.hw_dropout.launches)
    assert torch.equal(ln.layer_norm(x, scale, bias, 1e-5),
                       ln.layer_norm_plain(x, scale, bias, 1e-5))
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    ln.layer_norm(*leaves, 1e-5).backward(torch.ones_like(x))
    want = ln.layer_norm_backward_plain(x, scale, torch.ones_like(x), 1e-5)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    got = ln.layer_norm_backward(x, scale, torch.ones_like(x), 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(dr.hw_dropout(x, 5, 0.25), dr.hw_dropout_plain(x, 5,
                                                                      0.25))
    leaf = x.clone().requires_grad_()
    dr.hw_dropout(leaf, 5, 0.25).backward(torch.ones_like(x))
    assert torch.equal(leaf.grad, dr.hw_dropout_plain(torch.ones_like(x), 5,
                                                      0.25))
    assert (ln.layer_norm.launches, ln.layer_norm.variant_launches,
            ln.layer_norm_backward.launches, dr.hw_dropout.launches) == marks


def test_lean_wrappers_raise_what_they_raised():
    x, scale, bias = _ln_case(4, 8)
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ln.layer_norm(meta, scale.to("meta"), bias.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ln.layer_norm_backward(meta, scale.to("meta"), meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dr.hw_dropout(meta, 3, 0.1)
    with pytest.raises(ValueError, match="one device"):
        ln.layer_norm(x, scale.to("meta"), bias)
    # What the CUDA path checks before its launch, in the order it does.
    assert ln._check_kernel_inputs(x.bfloat16(), scale, bias) == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._check_kernel_inputs(x.half(), scale, bias)
    with pytest.raises(TypeError, match="float32 scale"):
        ln._check_kernel_inputs(x, scale.double(), bias.double())
    with pytest.raises(ValueError, match="D <= 1024"):
        ln._check_kernel_inputs(torch.zeros(4, 2048), torch.ones(2048),
                                torch.zeros(2048))
    assert dr._dtype_code(x) == 0 and dr._dtype_code(x.bfloat16()) == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dr._dtype_code(x.half())


@pytest.mark.parametrize("dtype,t,d,head_dim,variant", [
    (BF16, 50, 512, 64, "tc"),      # the flagship ViT
    (BF16, 64, 512, 64, "tc"),      # T at a block's 64 rows
    (BF16, 17, 192, 64, "tc"),      # D not a multiple of 128
    (BF16, 1, 64, 64, "tc"),
    (F32, 50, 512, 64, "tile"),     # float32 keeps the present kernels
    (BF16, 50, 512, 32, "tile"),    # heads of another width
    (BF16, 50, 96, 64, "tile"),     # D not a multiple of 64
    (BF16, 65, 512, 64, "tile"),    # T past 64: the kernels raise
    (BF16, 50, 576, 64, "tile"),    # D past 512: the kernels raise
])
def test_attention_variant_rule(dtype, t, d, head_dim, variant):
    assert fb._attn_variant(dtype, t, d, head_dim) == variant
    assert variant in fb.ATTN_VARIANTS


def test_fused_block_entries_follow_the_source():
    """Each C entry the wrapper binds is an extern "C" function of
    csrc/fused_block.cu with as many parameters and its return type."""
    import ctypes

    src = (CSRC / "fused_block.cu").read_text()
    found = {name: (ret, params.count(",") + 1) for ret, name, params in
             re.findall(r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src)}
    restypes = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    signatures = fb._signatures()
    assert sorted(signatures) == sorted(found)
    for name, (restype, argtypes) in signatures.items():
        assert (restype, len(argtypes)) == (restypes[found[name][0]],
                                            found[name][1]), name


def _attn_case(dtype, b=2, t=5, d=16, heads=2, head_dim=8, seed=0):
    rng = np.random.default_rng(seed)
    new = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32))
    inner = heads * head_dim
    x = new(b, t, d).to(dtype)
    weights = [new(inner, d, scale=d ** -0.5).t() for _ in range(3)]
    weights.append(new(d, inner, scale=inner ** -0.5).t())
    vectors = [new(d) * 0.3, 1 + new(d) * 0.1, new(d) * 0.3]
    return x, new(b, t, d).to(dtype), tuple(weights + vectors)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_wrappers_run_the_plain_versions_on_the_cpu(dtype, rate):
    x, gy, params = _attn_case(dtype)
    seed = 21 if rate else None
    counts = lambda: (fb.attn_block.launches, fb.attn_block.tc_launches,  # noqa: E731
                      fb.attn_block_backward.launches,
                      fb.attn_block_backward.tc_launches)
    marks = counts()
    with torch.no_grad():
        assert torch.equal(fb.attn_block(x, *params, seed, 2, rate),
                           fb.attn_block_reference(x, *params, seed, 2, rate))
        got = fb.attn_block_backward(x, *params, gy, seed, 2, rate)
        want = fb.attn_block_backward_reference(x, *params, gy, seed, 2,
                                                rate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [p.clone().requires_grad_() for p in (x,) + params]
    fb.attn_block(leaves[0], *leaves[1:], seed, 2, rate).backward(gy)
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves, want))
    assert counts() == marks


def test_tc_weights_are_the_stored_matrices():
    """The tc kernels read each weight as an (out, in) matrix is stored:
    for the (in, out) view of such a matrix, which the model hands over,
    its cast with no transposed copy."""
    x, _, params = _attn_case(BF16)
    stored, pointers = fb._stored_weights(x, *params[:4])
    for w, s, p in zip(params[:4], stored, pointers):
        assert s.is_contiguous() and s.dtype == BF16
        assert torch.equal(s, w.t().to(BF16)) and p == s.data_ptr()
    dense = params[0].contiguous()            # an (in, out) matrix as is
    (copied,), _ = fb._stored_weights(x, dense)
    assert copied.is_contiguous() and torch.equal(copied, dense.t().to(BF16))


@pytest.mark.parametrize("dtype,d,f,variant", [
    (BF16, 512, 512, "tc"),     # the flagship ViT
    (BF16, 64, 64, "tc"),
    (BF16, 192, 320, "tc"),     # neither a multiple of 128
    (BF16, 512, 128, "tc"),
    (F32, 512, 512, "tile"),    # float32 keeps the present kernels
    (BF16, 96, 512, "tile"),    # D not a multiple of 64
    (BF16, 512, 100, "tile"),   # F not a multiple of 64
    (BF16, 32, 64, "tile"),
    (BF16, 512, 2048, "tc"),    # F is not held in shared memory
    (BF16, 576, 512, "tile"),   # D past 512: the kernels raise
])
def test_mlp_variant_rule(dtype, d, f, variant):
    assert fb._mlp_variant(dtype, d, f) == variant
    assert variant in fb.MLP_VARIANTS


def _mlp_case(dtype, b=2, t=5, d=16, f=24, seed=0):
    rng = np.random.default_rng(seed)
    new = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32))
    x = new(b, t, d).to(dtype)
    params = (new(f, d, scale=d ** -0.5).t(), new(f) * 0.3,
              new(d, f, scale=f ** -0.5).t(), new(d) * 0.3,
              1 + new(d) * 0.1, new(d) * 0.3)
    return x, new(b, t, d).to(dtype), params


def _mlp_counts():
    return (fb.mlp_block.launches, fb.mlp_block.tc_launches,
            fb.mlp_block_backward.launches,
            fb.mlp_block_backward.tc_launches)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_mlp_wrappers_run_the_plain_versions_on_the_cpu(dtype, rate):
    """Forward, backward and autograd through mlp_block on the CPU equal
    the plain versions, and no launch counter moves."""
    x, gy, params = _mlp_case(dtype)
    seed = 33 if rate else None
    marks = _mlp_counts()
    with torch.no_grad():
        assert torch.equal(fb.mlp_block(x, *params, seed, rate),
                           fb.mlp_block_reference(x, *params, seed, rate))
        got = fb.mlp_block_backward(x, *params, gy, seed, rate)
        want = fb.mlp_block_backward_reference(x, *params, gy, seed, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [p.clone().requires_grad_() for p in (x,) + params]
    fb.mlp_block(leaves[0], *leaves[1:], seed, rate).backward(gy)
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves, want))
    assert _mlp_counts() == marks


def test_mlp_tc_weights_are_the_stored_matrices():
    """The MLP's tc kernels read w1 and w2 as the (out, in) matrices are
    stored: the cast of the (in, out) view the model hands over, and for a
    view of a matrix already in x's dtype that matrix itself, no copy."""
    x, _, params = _mlp_case(BF16)
    for w in (params[0], params[2]):
        stored = fb._stored(x, w)
        assert stored.is_contiguous() and stored.dtype == BF16
        assert torch.equal(stored, w.t().to(BF16))
        held = w.t().to(BF16)                 # stored (out, in) in bf16
        assert fb._stored(x, held.t()).data_ptr() == held.data_ptr()
