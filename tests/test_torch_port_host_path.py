"""The host path of the kernel wrappers, on the CPU: the short-sequence
attention (K1), grayscale (K2), flash attention (K3), LayerNorm (K4),
standalone dropout (K5) and fused sub-block (K6a-d). The rules that pick
the LayerNorm kernels' instantiations and each sub-block's variant, the C
entries the wrappers bind against the source, and the dispatch that the
lean wrappers keep (the plain versions for a CPU tensor, no launch counted,
the kernels' input checks with their error types and messages, the launch
through ``kernels/build.py:launch``)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from videocad_tpu_torch.ops import attention as fl
from videocad_tpu_torch.ops import dropout as dr
from videocad_tpu_torch.ops import fused_attention as fa
from videocad_tpu_torch.ops import fused_block as fb
from videocad_tpu_torch.ops import layernorm as ln
from videocad_tpu_torch.ops import preprocess as pp

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
    assert _kernel_table("kFwdVariants") == ln.FWD_VARIANTS


def _kernel_table(name):
    """The variants named in the comments of csrc/layernorm.cu's table
    ``name``, in the order of their codes."""
    src = (CSRC / "layernorm.cu").read_text()
    table = src[src.index(name + "[] = {"):]
    table = table[:table.index("};")]
    named = re.findall(r"// (\d) (\w+/\w+)", table)
    assert [int(code) for code, _ in named] == list(range(8))
    return tuple(variant for _, variant in named)


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
    (512, BF16, False, "bfloat16/scalar"),  # x or g an unaligned view
    (1024, F32, False, "float32/scalar"),
])
def test_backward_variant_rule(d, dtype, aligned, variant):
    assert ln.backward_variant(d, dtype, aligned) == variant
    assert variant in ln.BWD_VARIANTS


def test_backward_variant_codes_follow_the_kernel_table():
    """BWD_VARIANTS is the order of csrc/layernorm.cu's kBwdVariants: the
    code the backward's wrapper passes picks the entry that its comment
    names."""
    assert _kernel_table("kBwdVariants") == ln.BWD_VARIANTS


@pytest.mark.parametrize("key,value,field", [
    ("warps", 4, 5), ("warp_rows", 4, 3), ("prefetch", 0, 6),
    ("block_rows", 128, 7)])
def test_ln_bwd_sweep_rewrites_the_backward_table(key, value, field):
    """cli/ln_bwd_sweep.py's copies of csrc/layernorm.cu: each vector and
    exact-width row of kBwdVariants takes the value, the scalar rows and
    kBwdSmall stay; "table" everywhere is the source as it is, and
    min_blocks caps the row kernel's registers."""
    from videocad_tpu_torch.cli import ln_bwd_sweep as sweep

    src = (CSRC / "layernorm.cu").read_text()
    table = dict.fromkeys(sweep.OPTIONS, "table")
    assert sweep.variant_source(src, table) == src
    out = sweep.variant_source(src, {**table, key: value})
    rows = [sweep.ROW.findall(text[text.index("kBwdVariants[] = {"):])[:8]
            for text in (src, out)]
    want = "false" if key == "prefetch" else str(value)
    for before, after in zip(*rows):
        expect = list(before)
        if before[1] != "1":
            expect[field] = want
        assert list(after) == expect
    small = [text[text.index("kBwdSmall[] = {"):] for text in (src, out)]
    assert small[0] == small[1]
    capped = sweep.variant_source(src, {**table, "min_blocks": 2})
    assert "__launch_bounds__(W * 32, 2)\nlayer_norm_bwd_kernel(" in capped


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


# ---- K1, K2, K3: the short-sequence and flash attention, the grayscale ----

_C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
            "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "double": ctypes.c_double}


def _c_entries(source):
    """{name: (return type, [parameter types])} of the extern "C" functions
    of ``csrc/<source>``, each parameter as the ctypes type that carries
    it (every pointer as c_void_p)."""
    src = (CSRC / source).read_text()
    entries = {}
    for ret, name, params in re.findall(
            r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src):
        types = []
        for param in params.split(","):
            param = " ".join(param.split())
            kind = param.rsplit(" ", 1)[0].replace("const ", "")
            types.append(ctypes.c_void_p if "*" in param else _C_TYPES[kind])
        entries[name] = (_C_TYPES[ret], types)
    return entries


@pytest.mark.parametrize("dtype,t,head_dim,variant", [
    (BF16, 50, 64, "tc"),           # the flagship ViT
    (BF16, 64, 64, "tc"),           # T at the first instantiation's limit
    (BF16, 65, 64, "tc_wide"),      # the GenCAD CAD encoder
    (BF16, 128, 16, "tc_wide"),     # T at the wide one's
    (F32, 50, 64, "scalar"),        # float32 keeps the scalar kernels
    (F32, 65, 64, "scalar_wide"),
    (BF16, 65, 8, "scalar_wide"),   # D no multiple of 16
    (BF16, 13, 8, "scalar"),
])
def test_k1_variant_rule(dtype, t, head_dim, variant):
    """The variant by dtype and head width, the instantiation by T: the
    T <= 64 kernels exactly where they ran before the wide ones came."""
    assert fa._kernel_variant(dtype, t, head_dim) == variant
    assert variant in fa.VARIANTS


@pytest.mark.parametrize("module,source", [
    (fa, "mhsa_short.cu"), (pp, "gray_normalize.cu"),
    (fl, "flash_attention.cu"), (ln, "layernorm.cu")])
def test_bound_entries_follow_the_source(module, source):
    """Each C entry a wrapper binds is an extern "C" function of its source
    with the same return and parameter types, in order: a changed entry
    and a stale binding cannot pass each other here."""
    assert module._signatures() == _c_entries(source)


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _attention_counts():
    return tuple((f.launches, f.tc_launches) for f in (
        fa.mhsa_short, fa.mhsa_short_backward, fl.flash_attention,
        fl.flash_attention_dq, fl.flash_attention_dkv))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_k1_k3_wrappers_run_the_plain_versions_on_the_cpu(dtype, rate):
    """mhsa_short and flash_attention on CPU tensors, with and without
    autograd, equal their plain versions, and no launch counter moves."""
    seed = 17 if rate else None
    marks = _attention_counts()
    q, k, v, g = _qkv((2, 6, 32), dtype, 1)
    with torch.no_grad():
        assert torch.equal(fa.mhsa_short(q, k, v, seed, 4, rate),
                           fa.mhsa_short_reference(q, k, v, seed, 4, rate))
    want = fa.mhsa_short_backward_reference(q, k, v, g, seed, 4, rate)
    got = fa.mhsa_short_backward(q, k, v, g, seed, 4, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.mhsa_short(*leaves, seed, 4, rate).backward(g)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))

    q, k, v, g = _qkv((2, 7, 2, 16), dtype, 2)
    mask = fl.BandMask(7, 7, 3)
    out, lse = fl.flash_attention_reference(q, k, v, mask, seed, rate)
    with torch.no_grad():
        assert torch.equal(fl.flash_attention(q, k, v, mask, seed, rate), out)
    want = fl.flash_attention_backward_reference(q, k, v, mask, seed, out,
                                                 lse, g, rate)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fl.flash_attention(*leaves, mask, seed, rate).backward(g)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert _attention_counts() == marks


@pytest.mark.parametrize("target", [None, (6, 10), (8, 8)])
def test_gray_wrapper_runs_the_plain_path_on_the_cpu(target):
    """grayscale_normalize_fused on a CPU tensor is grayscale_normalize, with
    the resize or without (a target equal to the input's size is none), and
    neither launch counter moves."""
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (2, 3, 8, 8, 3),
                                           dtype=np.uint8))
    fused = pp.grayscale_normalize_fused
    marks = (fused.launches, fused.resize_launches)
    for bgr_as_rgb in (False, True):
        assert torch.equal(fused(images, bgr_as_rgb, target),
                           pp.grayscale_normalize(images, bgr_as_rgb, target))
    assert (fused.launches, fused.resize_launches) == marks


def test_k1_k2_k3_wrappers_raise_what_they_raised():
    """A tensor on neither the CPU nor a card, and what the kernels' checks
    refuse (float16 among it), raise the errors they raised before their
    launches went through build.launch; the checks run before anything
    touches a card."""
    meta = torch.zeros(2, 6, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.mhsa_short(meta, meta, meta, None, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.mhsa_short_backward(meta, meta, meta, meta, None, 4)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pp.grayscale_normalize_fused(
            torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device="meta"))
    flash = torch.zeros(2, 7, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention(flash, flash, flash)
    cpu = torch.zeros(2, 7, 2, 16)
    lse = torch.zeros(2, 2, 7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_dq(cpu, cpu, cpu, None, None, cpu, lse, cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_dkv(cpu, cpu, cpu, None, None, lse, lse, cpu)

    q = torch.zeros(2, 6, 32)
    assert fa._check_kernel_inputs((q, q, q), 4) == (2, 6, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_kernel_inputs((q.half(),) * 3, 4)
    with pytest.raises(ValueError, match="T <= 128"):
        fa._check_kernel_inputs((torch.zeros(1, 129, 8),) * 3, 1)
    # T = 65 (the GenCAD CAD encoder) is taken, by the wide instantiation.
    assert fa._check_kernel_inputs((torch.zeros(1, 65, 8),) * 3, 1) == (
        1, 65, 8)
    with pytest.raises(ValueError, match="D <= 64"):
        fa._check_kernel_inputs((torch.zeros(1, 6, 128),) * 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_kernel_inputs((q, q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), q), 4)
    card = torch.device("cuda", 0)   # a name only: nothing touches a card
    fl._check_kernel_inputs(card, cpu, cpu, cpu)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl._check_kernel_inputs(card, cpu.half(), cpu.half(), cpu.half())
    with pytest.raises(ValueError, match="D <= 256"):
        fl._check_kernel_inputs(card, torch.zeros(1, 4, 1, 320))
    with pytest.raises(ValueError, match="contiguous"):
        fl._check_kernel_inputs(card, cpu, cpu.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    pp._check_kernel_inputs(torch.zeros(2, 8, 8, 3, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        pp._check_kernel_inputs(torch.zeros(2, 8, 8, 3, dtype=torch.float16))


def test_no_wrapper_enters_a_device_guard_or_builds_a_stream_object():
    """Every kernel wrapper under ops/ reaches its C entry through
    kernels/build.py:launch (the raw current stream, a device guard only
    off the current device): none enters torch.cuda.device or reads
    torch.cuda.current_stream on its own."""
    ops = Path(ln.__file__).resolve().parent
    for path in sorted(ops.glob("*.py")):
        src = path.read_text()
        assert "torch.cuda.device(" not in src, path.name
        assert "current_stream(" not in src, path.name
