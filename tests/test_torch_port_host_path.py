"""The host path of the standalone dropout (K5) and LayerNorm (K4)
wrappers, on the CPU: the rule that picks the LayerNorm forward's
instantiation, and the dispatch that the lean wrappers keep (the plain
versions for a CPU tensor, no launch counted, the kernels' input checks
with their error types and messages)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from videocad_tpu_torch.ops import dropout as dr
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
