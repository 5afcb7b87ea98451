"""The PyTorch port's ops against the JAX package, plus the port's guards.

Inputs are made with numpy from a seed and fed to both packages. The JAX
fused attention runs its Pallas kernel in interpret mode, as
tests/test_fused_attention.py runs it on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocad_tpu.actions import ops as jax_action_ops
from videocad_tpu.actions import vocab as jax_vocab
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.ops import dropout as jax_dropout
from videocad_tpu.ops import fused_attention as jax_fused
from videocad_tpu.ops import layernorm as jax_layernorm
from videocad_tpu.ops import preprocess as jax_preprocess
from videocad_tpu.ops import prng as jax_prng
from videocad_tpu_torch.actions import ops as port_action_ops
from videocad_tpu_torch.actions import vocab as port_vocab
from videocad_tpu_torch.cli import serve as port_serve
from videocad_tpu_torch.kernels import build as port_build
from videocad_tpu_torch.models import (create_model, example_inputs,
                                       flagship_config)
from videocad_tpu_torch.ops import attention as port_flash
from videocad_tpu_torch.ops import dropout as port_dropout
from videocad_tpu_torch.ops import fused_attention as port_fused
from videocad_tpu_torch.ops import layernorm as port_layernorm
from videocad_tpu_torch.ops import preprocess as port_preprocess
from videocad_tpu_torch.ops import prng as port_prng
from tests.helpers import TINY_CONFIG


def _qkv(b, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, hd), dtype=np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("b,t,h,d", [
    (2, 50, 16, 64),   # the flagship ViT shape
    (2, 16, 2, 32),
    (3, 13, 2, 8),     # uneven T
])
def test_mhsa_short_reference_matches_jax(b, t, h, d):
    q, k, v = _qkv(b, t, h * d, seed=b * 100 + t)
    expected = jax_fused.mhsa_short(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.int32(0), h, 0.0)
    got = port_fused.mhsa_short_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


def test_mhsa_short_on_cpu_runs_the_plain_version_and_launches_nothing(
        monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 50, 1024, seed=7))
    monkeypatch.setattr(port_fused.mhsa_short, "launches", 0)
    monkeypatch.setattr(port_fused.mhsa_short_backward, "launches", 0)
    got = port_fused.mhsa_short(q, k, v, None, 16)
    torch.testing.assert_close(
        got, port_fused.mhsa_short_reference(q, k, v, None, 16), rtol=0,
        atol=0)
    # With a gradient wanted and dropout on: still the plain versions.
    q.requires_grad_()
    out = port_fused.mhsa_short(q, k, v, 5, 16, 0.1)
    out.sum().backward()
    assert port_fused.mhsa_short.launches == 0
    assert port_fused.mhsa_short_backward.launches == 0
    torch.testing.assert_close(
        out.detach(), port_fused.mhsa_short_reference(q.detach(), k, v, 5, 16,
                                                      0.1), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,seq,head_dim,variant", [
    (torch.bfloat16, 50, 64, "tc"),       # the flagship ViT
    (torch.bfloat16, 1, 16, "tc"),
    (torch.bfloat16, 64, 48, "tc"),
    (torch.bfloat16, 17, 32, "tc"),
    (torch.float32, 50, 64, "scalar"),    # TF32 would break 1e-5
    (torch.bfloat16, 13, 8, "scalar"),    # D not a multiple of 16
    (torch.bfloat16, 50, 40, "scalar"),
    (torch.float16, 50, 64, "scalar"),
])
def test_mhsa_short_kernel_variant_rule(dtype, seq, head_dim, variant):
    """Which kernel a CUDA call launches: a pure function of the dtype and
    the shape (the wrapper raises for what neither variant takes)."""
    assert port_fused._kernel_variant(dtype, seq, head_dim) == variant


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("head_dim", [8, 16, 40, 64, 256, 272])
def test_flash_attention_kernel_variant_rule(dtype, head_dim):
    """Which flash attention kernels a CUDA call launches: the tensor-core
    variant for bfloat16 with D a multiple of 16 from 16 to 256 (the
    decoder's 256, the ViT's 64), the scalar one for the rest (float32:
    TF32 would break 2e-5; D = 272 is refused by the wrapper)."""
    tc = dtype == torch.bfloat16 and head_dim in (16, 64, 256)
    assert port_flash._kernel_variant(dtype, head_dim) == (
        "tc" if tc else "scalar")


def test_kernel_library_name_follows_its_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and every csrc/*.cuh, so an
    edited header never loads a stale library; another source's edit
    leaves it alone. On a copy of csrc/ in a temporary directory."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in port_build.CSRC_DIR.iterdir():
        if path.suffix in (".cu", ".cuh"):
            (csrc / path.name).write_bytes(path.read_bytes())
    assert (csrc / "tc_common.cuh").is_file()
    monkeypatch.setattr(port_build, "CSRC_DIR", csrc)
    before = port_build.library_path("flash_attention")
    assert before == port_build.library_path("flash_attention")
    with open(csrc / "layernorm.cu", "a") as f:
        f.write("\n// another source's edit\n")
    assert port_build.library_path("flash_attention") == before
    with open(csrc / "tc_common.cuh", "a") as f:
        f.write("\n// an edited header\n")
    after = port_build.library_path("flash_attention")
    assert after != before and after.parent == before.parent
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert port_build.library_path("flash_attention") != after
    assert port_build.sources() == sorted(
        p.stem for p in csrc.glob("*.cu"))


def test_mhsa_short_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 32, seed=1))
    with pytest.raises(ValueError):
        port_fused.mhsa_short(q, k[:, :4], v, None, 2)
    with pytest.raises(ValueError):
        port_fused.mhsa_short(q, k, v, None, 3)
    with pytest.raises(ValueError, match="explicit int32 seed"):
        port_fused.mhsa_short(q, k, v, None, 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not in"):
        port_fused.mhsa_short(q, k, v, 1, 2, dropout_rate=1.0)
    with pytest.raises(ValueError, match="g like q"):
        port_fused.mhsa_short_backward(q, k, v, q[:, :4], None, 2)


def _jax_mhsa_grads(q, k, v, g, h):
    def fn(q_, k_, v_):
        out = jax_fused.mhsa_short(q_, k_, v_, jnp.int32(0), h, 0.0)
        return (out * jnp.asarray(g)).sum()
    return jax.grad(fn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))


@pytest.mark.parametrize("b,t,h,d", [(2, 50, 4, 64), (3, 13, 2, 8)])
def test_mhsa_short_gradients_match_jax(b, t, h, d):
    """The port's autograd Function on the CPU (plain forward, the backward
    reference that follows the kernel's formula) against jax.grad of the
    JAX kernel in interpret mode, float32, dropout off."""
    q, k, v = _qkv(b, t, h * d, seed=b + t)
    g = np.random.default_rng(9).standard_normal((b, t, h * d),
                                                 dtype=np.float32)
    want = _jax_mhsa_grads(q, k, v, g, h)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_fused.mhsa_short(tq, tk, tv, None, h)
    assert isinstance(out.grad_fn, port_fused._MhsaShort._backward_cls)
    out.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def _autograd_through_reference(q, k, v, g, seed, h, rate):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = port_fused.mhsa_short_reference(q, k, v, seed, h, rate)
    return torch.autograd.grad(out, (q, k, v), g)


@pytest.mark.parametrize("dtype,rate,tol", [
    (torch.float32, 0.0, 1e-5), (torch.float32, 0.3, 1e-5),
    (torch.bfloat16, 0.0, 2e-2), (torch.bfloat16, 0.1, 2e-2)])
def test_mhsa_short_backward_reference_matches_autograd(dtype, rate, tol):
    """The backward's plain version (the kernel's formula and rounding
    points) against autograd through the plain forward, which draws the
    same mask from the same seed."""
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in
                  _qkv(2, 50, 128, seed=11) + _qkv(2, 50, 128, seed=12)[:1])
    seed = 77 if rate else None
    want = _autograd_through_reference(q, k, v, g, seed, 2, rate)
    got = port_fused.mhsa_short_backward_reference(q, k, v, g, seed, 2, rate)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        assert (a.float() - w.float()).abs().max().item() <= tol


def test_dropout_bits_are_a_pure_function_of_seed_and_indices():
    """The block-size test: a batch drawn whole equals the same rows drawn
    one at a time, and a prefix of heads, queries or keys equals the same
    entries of a larger draw."""
    whole = port_prng.dropout_bits(123, 5, 3, 13, 50)
    assert whole.shape == (5, 3, 13, 50) and whole.dtype == torch.int64
    assert whole.min() >= 0 and whole.max() < 2 ** 32
    for b in range(5):
        row = port_prng.dropout_bits(123, 1, 3, 13, 50, batch_offset=b)
        assert torch.equal(row[0], whole[b])
    smaller = port_prng.dropout_bits(123, 2, 2, 7, 33)
    assert torch.equal(smaller, whole[:2, :2, :7, :33])
    assert not torch.equal(port_prng.dropout_bits(124, 5, 3, 13, 50), whole)


def test_philox_known_answers():
    """Philox4x32-10 against the published known-answer vectors."""
    word = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for counter, key, want in cases:
        got = port_prng.philox4x32(tuple(word(c) for c in counter), key)
        assert tuple(int(x) for x in got) == want


def test_attention_dropout_mask_statistics_and_seeds():
    rate = 0.1
    keep = port_prng.keep_mask(port_prng.dropout_bits(1, 16, 4, 50, 50), rate)
    assert abs(1.0 - keep.float().mean().item() - rate) < 0.005
    other = port_prng.keep_mask(port_prng.dropout_bits(2, 16, 4, 50, 50),
                                rate)
    assert not torch.equal(keep, other)
    # Through the op: with V = identity per head the output is the dropped
    # weights themselves, so zeros are the dropped entries and each kept
    # row sums to about 1 / (1 - rate) of what survived.
    b, t, h = 4, 16, 2
    q, k, _ = (torch.from_numpy(x) for x in _qkv(b, t, h * t, seed=3))
    eye = torch.eye(t).repeat(1, h).expand(b, t, h * t).contiguous()
    out = port_fused.mhsa_short(q, k, eye, 9, h, rate)
    got_keep = out.reshape(b, t, h, t).permute(0, 2, 1, 3) > 0
    want_keep = port_prng.keep_mask(port_prng.dropout_bits(9, b, h, t, t),
                                    rate)
    assert torch.equal(got_keep, want_keep)
    plain = port_fused.mhsa_short(q, k, eye, None, h)
    torch.testing.assert_close(out[out > 0], (plain / (1 - rate))[out > 0])


def test_dropout_threshold_and_seed_rules_equal_jax():
    for rate in [0.0, 1e-12, 0.001, 0.1, 0.25, 0.5, 0.9, 0.999999, 1.0]:
        assert (port_prng.dropout_threshold(rate)
                == jax_prng.dropout_threshold(rate)), rate
    bits = np.asarray([0, 429496729, 429496730, 2 ** 32 - 1], dtype=np.uint32)
    np.testing.assert_array_equal(
        port_prng.keep_mask(torch.from_numpy(bits.astype(np.int64)),
                            0.1).numpy(),
        np.asarray(jax_prng.keep_mask(jnp.asarray(bits), 0.1)))
    port_prng.require_seed(None, 0.0, "op")
    with pytest.raises(ValueError, match="explicit int32 seed"):
        port_prng.require_seed(None, 0.1, "op")
    gen = torch.Generator().manual_seed(0)
    seeds = [port_prng.derive_seed(gen) for _ in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2 ** 31 - 1 for s in seeds)
    gen = torch.Generator().manual_seed(0)
    assert seeds == [port_prng.derive_seed(gen) for _ in range(4)]
    assert port_prng.fold_in(3, 0) != port_prng.fold_in(3, 1)
    assert 0 <= port_prng.fold_in(2 ** 63 - 1, 2 ** 40) < 2 ** 63


@pytest.mark.parametrize("rate,effective", [(0.1, 26 / 256), (0.5, 0.5),
                                            (0.001, 0.001)])
def test_elementwise_dropout_keeps_both_rate_rules(rate, effective):
    """The u8 rule realizes rate 0.1 as 26/256 and scales by the effective
    rate, so E[y] = x; a rate off the u8 grid takes the exact u32 path."""
    x = torch.full((400, 1000), 2.0)
    y = port_dropout.dropout(x, port_dropout.DropoutRng(0), rate)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - effective) < 0.02 * effective + 3e-4
    kept = y[y != 0]
    np.testing.assert_allclose(kept.unique().numpy(), [2.0 / (1 - effective)],
                               rtol=1e-6)
    assert abs(y.mean().item() - 2.0) < 0.01
    # The same rule as the JAX package's, on its own bits.
    jy = np.asarray(jax_dropout.dropout(jnp.full((400, 1000), 2.0),
                                        jax.random.PRNGKey(0), rate))
    np.testing.assert_allclose(np.unique(jy[jy != 0]), kept.unique().numpy(),
                               rtol=1e-6)
    assert abs((jy == 0).mean() - dropped) < 0.02 * effective + 6e-4


def test_elementwise_dropout_guards_and_gradient():
    x = torch.ones(64, 64, requires_grad=True)
    rng = port_dropout.DropoutRng(1)
    assert port_dropout.dropout(x, rng, 0.0) is x
    assert port_dropout.dropout(x, None, 0.0, impl="pallas") is x
    with pytest.raises(ValueError, match="unknown dropout impl"):
        port_dropout.dropout(x, rng, 0.1, impl="mosaic")
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="needs a DropoutRng"):
            port_dropout.dropout(x, None, 0.1, impl=impl)
        x.grad = None
        y = port_dropout.dropout(x, rng, 0.25, impl=impl)
        y.sum().backward()
        torch.testing.assert_close(x.grad, y.detach())  # mask times 1/keep
    rng = port_dropout.DropoutRng(5)
    assert rng.seeds.device.type == "cpu" and rng.bits.device.type == "cpu"
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        port_prng.derive_seed(type("G", (), {"device": torch.device("meta")})())


@pytest.mark.parametrize("shape,target", [
    ((2, 3, 24, 20, 3), None),
    ((2, 24, 20, 3), (16, 12)),     # with the bilinear resize stage
    ((3, 16, 16, 1), None),
])
def test_grayscale_normalize_matches_jax(shape, target):
    images = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    expected = jax_preprocess.grayscale_normalize(
        jnp.asarray(images), True, target)
    got = port_preprocess.grayscale_normalize(torch.from_numpy(images), True,
                                              target)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)
    expected = jax_preprocess.maybe_preprocess(
        jnp.asarray(images), target_size=target or shape[-3:-1])
    got = port_preprocess.maybe_preprocess(
        torch.from_numpy(images), target_size=target or shape[-3:-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


def test_preprocess_rejects_bad_channels_and_passes_floats():
    with pytest.raises(ValueError, match="1 or 3 channels"):
        port_preprocess.grayscale_normalize(
            torch.zeros((1, 4, 4, 2), dtype=torch.uint8))
    floats = torch.rand(1, 4, 4, 1)
    assert port_preprocess.maybe_preprocess(floats) is floats
    np.testing.assert_allclose(
        port_preprocess.normalize_only(
            torch.arange(256, dtype=torch.uint8)).numpy(),
        np.asarray(jax_preprocess.normalize_only(
            jnp.arange(256, dtype=jnp.uint8))), atol=1e-6)
    one_channel = torch.arange(32, dtype=torch.uint8).reshape(1, 4, 8, 1)
    torch.testing.assert_close(
        port_preprocess.grayscale_normalize_fused(one_channel),
        port_preprocess.grayscale_normalize(one_channel), rtol=0, atol=0)


@pytest.mark.parametrize("shape,target", [
    ((2, 3, 24, 20, 3), None),        # the plain kernel's function
    ((2, 24, 20, 3), (16, 12)),       # with the resize inside the kernel
    ((3, 7, 9, 3), (14, 18)),         # upscaling: clamped edge taps
])
def test_fused_preprocess_matches_the_jax_kernel(shape, target, monkeypatch):
    """The JAX Pallas kernel (in interpret mode) against the port's
    ``preprocess_impl="pallas"`` entry, which on a CPU tensor runs the
    plain path and launches nothing (the CUDA kernels are held against that
    plain path on the card)."""
    images = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    if target is None:
        # The JAX wrapper gives this variant's pallas_call no interpret
        # flag, so it runs on a TPU only; its kernel body is applied here
        # to each image as one tile (a list stands in for the output ref).
        w = [float(x) for x in jax_preprocess._weights(3, True)]
        tiles = []
        for image in jnp.asarray(images).reshape((-1,) + shape[-3:]):
            out_ref = [None]
            jax_preprocess._gray_kernel(image[None], out_ref, w0=w[0],
                                        w1=w[1], w2=w[2])
            tiles.append(out_ref[0])
        expected = jnp.stack(tiles).reshape(shape[:-1] + (1,))
    else:
        expected = jax_preprocess.grayscale_normalize_pallas(
            jnp.asarray(images), True, target)
    fused = port_preprocess.grayscale_normalize_fused
    monkeypatch.setattr(fused, "launches", 0)
    monkeypatch.setattr(fused, "resize_launches", 0)
    got = port_preprocess.maybe_preprocess(
        torch.from_numpy(images), True, impl="pallas", target_size=target)
    assert fused.launches == 0 and fused.resize_launches == 0
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(expected.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


def test_resize_taps_rebuild_the_matrix():
    for n_in, n_out in [(20, 16), (256, 224), (7, 9), (3, 40), (5, 5)]:
        lo, hi, w_lo, w_hi = port_preprocess._resize_taps(n_in, n_out)
        assert lo.dtype == hi.dtype == np.int32
        assert w_lo.dtype == w_hi.dtype == np.float32
        assert ((0 <= lo) & (lo <= hi) & (hi < n_in)).all()
        assert (w_hi[lo == hi] == 0).all()
        mat = np.zeros((n_out, n_in), np.float32)
        for o in range(n_out):
            mat[o, lo[o]] += w_lo[o]
            mat[o, hi[o]] += w_hi[o]
        np.testing.assert_array_equal(mat,
                                      jax_preprocess._resize_matrix(n_in,
                                                                    n_out))


def test_resize_matrix_equals_jax():
    for n_in, n_out in [(20, 16), (256, 224), (7, 9), (3, 40), (224, 256)]:
        np.testing.assert_array_equal(port_preprocess._resize_matrix(n_in, n_out),
                                      jax_preprocess._resize_matrix(n_in, n_out))


def test_action_ops_match_jax_exactly():
    rng = np.random.default_rng(3)
    cmd = rng.integers(-1, 6, (4, 9))
    params = rng.integers(-1, 1000, (4, 9, 6))
    params[..., 2] = rng.choice([150, 200, 220, 249, 250, 400], (4, 9))
    expected = jax_action_ops.apply_action_mask(jnp.asarray(cmd),
                                                jnp.asarray(params))
    got = port_action_ops.apply_action_mask(torch.from_numpy(cmd),
                                            torch.from_numpy(params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    actions = np.concatenate([cmd[..., None], params], -1)
    np.testing.assert_array_equal(
        port_action_ops.normalize_actions(torch.from_numpy(actions)).numpy(),
        np.asarray(jax_action_ops.normalize_actions(jnp.asarray(actions))))


def test_vocab_constants_equal_the_jax_package():
    names = ["NUM_COMMANDS", "NUM_PARAMS", "NUM_BINS", "ACT_DIM",
             "ACTION_PARAM_MASK", "KEY3_WINDOW_LO", "KEY3_WINDOW_HI",
             "END_SENTINEL", "CMD_MOVE_TO", "CMD_PRESS_KEYS", "CMD_SCROLL",
             "CMD_TYPE", "CMD_CLICK", "PARAM_NAMES", "PARAM_TO_LABEL",
             "TOLERANCE", "PARAM_TOLERANCES", "PARAM_ABOVE",
             # the log ETL's
             "PAD_VALUE", "SCALE_FACTOR", "BIN", "MOVE_X_OFFSET",
             "DEFAULT_VECTOR", "KEY_MAP"]
    for name in names:
        assert getattr(port_vocab, name) == getattr(jax_vocab, name), name


def test_shard_path_equals_the_jax_package(tmp_path):
    """``data/native.py:shard_path`` is a copy of the JAX package's ETL
    helper, which the card's machine cannot import."""
    from videocad_tpu.etl.dataset_gen import shard_path as jax_shard_path
    from videocad_tpu_torch.data.native import shard_path
    for file_id, ext, kind in [("abcd1234", "vcb", "data"),
                               ("ab", "png", "frames"), ("0001xyz", "pkl", ""),
                               ("abcd1234", "png", "05")]:
        ours = shard_path(str(tmp_path / "port"), file_id, ext, kind)
        theirs = jax_shard_path(str(tmp_path / "jax"), file_id, ext, kind)
        assert (os.path.relpath(ours, tmp_path / "port")
                == os.path.relpath(theirs, tmp_path / "jax"))
        assert os.path.isdir(os.path.dirname(ours) if kind else ours)
    assert shard_path(str(tmp_path), "x1", "vcb") == jax_shard_path(
        str(tmp_path), "x1", "vcb")


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import videocad_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            videocad_tpu_torch.__path__, "videocad_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # cv2 too: the GenCAD data branch imports it where it runs only.
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "optax", "videocad_tpu",
                      "cv2"))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    # Every module of the package, the trainer's, the evaluation's, the
    # log ETL's and the QA harness's among them.
    assert int(out.stdout.split()[-1]) >= 70
    package = Path(__file__).resolve().parents[1] / "videocad_tpu_torch"
    for module in ["ops/layernorm.py", "utils/io.py", "data/collate.py",
                   "data/dataset.py", "data/pipeline.py",
                   "train/checkpoint.py", "train/preempt.py",
                   "train/trainer.py", "experiment.py", "cli/train.py",
                   "ops/attention.py", "cli/evaluate.py", "cli/plots.py",
                   "ops/fused_block.py", "models/resnet.py",
                   "models/decision_transformer.py", "infer/incremental.py",
                   "infer/interpret.py", "infer/export.py",
                   "cli/export_model.py", "data/native.py", "ops/quant.py",
                   "models/torch_checkpoint.py", "etl/log_parser.py",
                   "etl/handlers.py", "etl/dataset_gen.py", "qa/harness.py",
                   "qa/analysis.py", "cli/generate_dataset.py",
                   "cli/eval_qa.py", "cli/qa_analysis.py",
                   "cli/compute_class_weights.py", "parallel/mesh.py",
                   "parallel/sharding.py", "parallel/distributed.py",
                   "parallel/collectives.py", "parallel/dryrun.py"]:
        assert (package / module).is_file(), module


def test_serve_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_serve.parse_args(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_engine(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_engine(port_serve.parse_args(
            ["--device", "cuda", "--artifact", "x.vcdx"]))
    # --artifact is ported: a missing file is the only error left.
    with pytest.raises(FileNotFoundError):
        port_serve.build_engine(port_serve.parse_args(
            ["--device", "cpu", "--artifact", "x.vcdx"]))


@pytest.mark.parametrize("override,item", [
    ({"remat_encoder": True}, "remat_encoder"),
    ({"frame_chunk": 4}, "frame_chunk"),
    ({"quant": "int8"}, "quant"),
])
def test_unported_options_raise(override, item):
    """Options that raised before they were ported now build and run a
    forward and a backward (their parity: test_torch_port_remat.py,
    test_torch_port_quant.py)."""
    model = create_model(dict(TINY_CONFIG, **override))
    assert getattr(model.config, item) == override[item]
    inputs = {"frames": torch.zeros((2, 4, 32, 32, 3), dtype=torch.uint8),
              "cad_image": torch.zeros((2, 32, 32, 3), dtype=torch.uint8),
              "actions": torch.zeros((2, 4, 7))}
    model.train()
    cmd, params = model(inputs)
    (cmd.sum() + params.sum()).backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("override", [
    {"num_views": 2}, {"use_pretrained_cad_model": True},
    {"encoder": "resnet"}])
def test_named_config_options_build_and_run(override):
    """The options that raised until the port reached them build the
    modules of the JAX model and run a forward: views through the CAD
    encoder into ``embed_multiview``, the GenCAD CAD encoder at 256² and 3
    channels, ResNet18-GN encoders of 512-wide embeddings."""
    cfg = dict(TINY_CONFIG, **override)
    if override.get("use_pretrained_cad_model"):
        cfg["vit_patch"] = 32
    model = create_model(cfg)
    inputs = example_inputs(model.config, batch=2, seq_len=3)
    with torch.no_grad():
        cmd, params = model(inputs)
    assert cmd.shape == (2, 3, 5) and params.shape == (2, 3, 6, 1000)
    assert bool(torch.isfinite(cmd).all() and torch.isfinite(params).all())
    sd = model.state_dict()
    if "num_views" in override:
        assert sd["embed_multiview.weight"].shape == (32, 2 * 16)
        assert sd["image_projection.weight"].shape == (32, 3 * 32)
        assert inputs["multiview_images"].shape == (2, 2, 32, 32, 1)
    elif "encoder" in override:
        assert sd["state_encoder.stem_conv.weight"].shape == (64, 1, 7, 7)
        assert sd["embed_state.weight"].shape == (32, 512)
        assert sd["embed_image.weight"].shape == (32, 512)
    else:
        assert inputs["cad_image"].shape == (2, 256, 256, 3)
        # 8 x 8 patches of 32 x 32 x 3, and the cls token: T = 65.
        assert sd["cad_encoder.patch_embed.weight"].shape == (16, 32 * 32 * 3)
        assert sd["cad_encoder.pos_embedding"].shape == (1, 65, 16)


def test_gencad_with_views_raises_as_jax():
    with pytest.raises(ValueError, match="cannot be combined"):
        create_model(dict(TINY_CONFIG, use_pretrained_cad_model=True,
                          num_views=2))
    with pytest.raises(ValueError, match="cannot be combined"):
        jax_create_model(dict(TINY_CONFIG, use_pretrained_cad_model=True,
                              num_views=2)).init(
            jax.random.PRNGKey(0), {"actions": jnp.zeros((1, 2, 7)),
                                    "cad_image": jnp.zeros((1, 256, 256, 3)),
                                    "frames": jnp.zeros((1, 2, 32, 32, 1))})


def _tiny_inputs(t=4):
    rng = np.random.default_rng(0)
    acts = np.concatenate([rng.integers(0, 5, (1, t, 1)),
                           rng.integers(-1, 1000, (1, t, 6))], -1)
    return {"frames": torch.from_numpy(rng.integers(
                0, 256, (1, t, 32, 32, 3), dtype=np.uint8)),
            "cad_image": torch.from_numpy(rng.integers(
                0, 256, (1, 32, 32, 3), dtype=np.uint8)),
            "actions": torch.from_numpy(
                (acts / np.asarray([4.0] + [1000.0] * 6)).astype(np.float32))}


@pytest.mark.parametrize("override", [
    {"vit_attention_impl": "block"},
    {"vit_mlp_impl": "block"},
    {"vit_attention_impl": "fused", "vit_mlp_impl": "block"},
    {"vit_attention_impl": "block", "vit_mlp_impl": "block"},
    {"vit_attention_impl": "block", "ln_impl": "pallas"},
    {"vit_attention_impl": "block", "dtype": "bfloat16"},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_block_settings_build_and_run(override):
    """The fused sub-block settings, once refused as unported, build, keep
    the parameter names and give finite logits equal to the plain ViT's (a
    bf16 model within bf16's rounding of its own plain path)."""
    model = create_model(dict(TINY_CONFIG, **override),
                         generator=torch.Generator().manual_seed(1))
    plain = create_model(dict(TINY_CONFIG, dtype=override.get("dtype",
                                                              "float32")))
    assert list(model.state_dict()) == list(plain.state_dict())
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, want = model(_tiny_inputs()), plain(_tiny_inputs())
    tol = 1e-5 if "dtype" not in override else 5e-2
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("override", [{"vit_attention_impl": "mosaic"},
                                      {"vit_mlp_impl": "fused"},
                                      {"attention_impl": "mosaic"}],
                         ids=lambda o: "-".join(o.values()))
def test_unknown_impl_names_raise(override):
    with pytest.raises(ValueError, match="unknown"):
        create_model(dict(TINY_CONFIG, **override))


def test_decoder_attention_impl_block_runs_the_plain_core():
    """As in the JAX decoder, where neither the "fused" nor the "pallas"
    branch matches "block": the plain core runs, with the same weights the
    same logits to the bit, and no kernel wrapper is entered."""
    from videocad_tpu_torch.ops import attention, fused_attention, fused_block

    model = create_model(dict(TINY_CONFIG, attention_impl="block"),
                         generator=torch.Generator().manual_seed(2))
    plain = create_model(TINY_CONFIG)
    plain.load_state_dict(model.state_dict())
    counts = lambda: (attention.flash_attention.launches,  # noqa: E731
                      fused_attention.mhsa_short.launches,
                      fused_block.attn_block.launches)
    before = counts()
    with torch.no_grad():
        got, want = model(_tiny_inputs(6)), plain(_tiny_inputs(6))
    assert counts() == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(m.attention_impl == "block" for n, m in model.named_modules()
               if n.startswith("decoder.") and hasattr(m, "attention_impl"))


def test_flagship_config_matches_the_jax_package():
    from videocad_tpu.models import factory as jax_factory
    from videocad_tpu_torch.models.videocadformer import VideoCADFormerConfig

    assert flagship_config() == jax_factory.flagship_config()
    port = dataclasses.asdict(VideoCADFormerConfig.from_json(flagship_config()))
    ref = dataclasses.asdict(jax_factory.VideoCADFormerConfig.from_json(
        jax_factory.flagship_config()))
    assert port == ref


def test_profile_busy_union_and_device_check(monkeypatch):
    from videocad_tpu_torch.cli import profile as port_profile

    # Overlapping and nested kernel intervals count once; gaps do not.
    assert port_profile._union_us([(5, 7), (0, 2), (1, 3), (5, 6)]) == 5
    assert port_profile._union_us([]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        port_profile.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        port_profile.main(["--device", "cpu"])


# ---- K4: LayerNorm ----

def _ln_inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    return x, scale, bias, g


# Row counts that are multiples of nothing the TPU kernel tiles by.
LN_CASES = [(7, 32), (400, 512), (1037, 32), (7, 1024), (37, 512)]


@pytest.mark.parametrize("rows,d", LN_CASES)
def test_layer_norm_plain_matches_jax_kernel_and_flax(rows, d):
    """Forward at float32: 1e-5 against the Pallas kernel in interpret mode
    and against flax nn.LayerNorm."""
    import flax.linen as nn

    x, scale, bias, _ = _ln_inputs(rows, d, seed=rows + d)
    got = port_layernorm.layer_norm(torch.from_numpy(x),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(bias), 1e-5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = jax_layernorm.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), 1e-5, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    flax_out = nn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(flax_out), atol=1e-5,
                               rtol=0)
    assert port_layernorm.layer_norm.launches == 0    # CPU: the plain version


@pytest.mark.parametrize("rows,d", [(7, 32), (400, 512)])
def test_layer_norm_plain_bf16_is_within_one_ulp_of_jax(rows, d):
    x, scale, bias, _ = _ln_inputs(rows, d, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = port_layernorm.layer_norm(xb, torch.from_numpy(scale),
                                    torch.from_numpy(bias), 1e-5)
    assert got.dtype == torch.bfloat16
    want = jax_layernorm.layer_norm(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), 1e-5, True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    # One unit in the last place of bf16 (8 significant bits) at the
    # output's magnitude; 1e-5 where the output is nearer 0 than that.
    exponent = torch.frexp(want.abs().clamp_min(1e-30))[1]
    ulp = torch.ldexp(torch.ones_like(want), exponent - 8).clamp_min(1e-5)
    assert ((got.float() - want).abs() <= ulp).all()


@pytest.mark.parametrize("rows,d", LN_CASES)
def test_layer_norm_plain_gradients_match_jax(rows, d):
    """dx, dscale, dbias of the plain backward (through the wrapper's
    autograd Function) against jax.grad through the Pallas kernels in
    interpret mode and through flax: 1e-5 of each gradient's largest
    entry."""
    x, scale, bias, g = _ln_inputs(rows, d, seed=rows * 3 + d)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    port_layernorm.layer_norm(*leaves, 1e-5).backward(torch.from_numpy(g))

    def pallas(x_, s_, b_):
        return jnp.sum(jax_layernorm.layer_norm(x_, s_, b_, 1e-5, True)
                       * jnp.asarray(g))

    def plain(x_, s_, b_):
        mean = x_.mean(-1, keepdims=True)
        var = ((x_ - mean) ** 2).mean(-1, keepdims=True)
        return jnp.sum(((x_ - mean) * jax.lax.rsqrt(var + 1e-5) * s_ + b_)
                       * jnp.asarray(g))

    args = tuple(jnp.asarray(a) for a in (x, scale, bias))
    for reference in (pallas, plain):
        want = jax.grad(reference, argnums=(0, 1, 2))(*args)
        for leaf, w, name in zip(leaves, want, ("dx", "dscale", "dbias")):
            w = np.asarray(w)
            np.testing.assert_allclose(
                leaf.grad.numpy() / np.abs(w).max(), w / np.abs(w).max(),
                atol=1e-5, rtol=0, err_msg=f"{name} vs {reference.__name__}")
    direct = port_layernorm.layer_norm_backward_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(g),
        1e-5)
    for leaf, d_ in zip(leaves, direct):
        torch.testing.assert_close(leaf.grad, d_, rtol=0, atol=0)


def test_layer_norm_guards():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="scale, bias"):
        port_layernorm.layer_norm(x, torch.ones(7), torch.zeros(8))
    with pytest.raises(ValueError, match="g like x"):
        port_layernorm.layer_norm_backward(x, torch.ones(8), torch.zeros(4, 7))
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port_layernorm.layer_norm(meta, torch.ones(8, device="meta"),
                                  torch.zeros(8, device="meta"))


# ---- K5: the standalone dropout ----

def test_elementwise_bits_are_a_function_of_seed_and_index():
    bits = port_prng.elementwise_bits(7, 1003)
    assert bits.shape == (1003,) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    # The bits of a prefix are the prefix of the bits, whatever the size.
    for n in (1, 4, 5, 1000):
        assert torch.equal(port_prng.elementwise_bits(7, n), bits[:n])
    assert not torch.equal(port_prng.elementwise_bits(8, 1003), bits)
    # The key's second word keeps the stream apart from the attention
    # kernels' bits for the same seed.
    attention = port_prng.dropout_bits(7, 1, 1, 1, 1003).reshape(-1)
    assert not torch.equal(attention, bits)
    # Word e % 4 of Philox4x32-10 at counter (e // 4, 0, 0, 0), key (7, 1).
    words = port_prng.philox4x32(
        tuple(torch.tensor([v]) for v in (250, 0, 0, 0)), (7, 1))
    assert [int(w) for w in words] == bits[1000:1003].tolist() + [
        int(port_prng.elementwise_bits(7, 1004)[1003])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hw_dropout_plain_properties(dtype):
    rate, n = 0.1, 400_000
    assert port_prng.dropout_threshold(rate) == jax_prng.dropout_threshold(
        rate)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (400, 1000)).astype(np.float32)).to(dtype)
    x[x == 0] = 1.0
    y = port_dropout.hw_dropout(x, 11, rate)
    assert y.dtype == dtype and y.shape == x.shape
    assert port_dropout.hw_dropout.launches == 0      # CPU: the plain version
    # The exact u32 rate 0.1 (within 4 sigma), not the u8 rule's 26 / 256.
    share = (y == 0).float().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - rate) <= 4 * sigma
    assert abs(share - rate) < abs(share - 26 / 256)
    # Kept values: x * 1/(1 - rate) in float32, rounded once.
    keep = y != 0
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    assert torch.equal(y[keep], (x.float() * inv_keep).to(dtype)[keep])
    # The same seed draws the same mask, another seed another.
    assert torch.equal(port_dropout.hw_dropout(x, 11, rate), y)
    assert not torch.equal(port_dropout.hw_dropout(x, 12, rate) != 0, keep)
    # The mask of a flat prefix is the prefix of the mask.
    flat = x.reshape(-1)
    for k in (1, 7, 1001, 4096):
        assert torch.equal(port_dropout.hw_dropout(flat[:k], 11, rate),
                           y.reshape(-1)[:k])
    # The backward is the forward applied to the cotangent.
    leaf = x.clone().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (400, 1000)).astype(np.float32)).to(dtype)
    port_dropout.hw_dropout(leaf, 11, rate).backward(g)
    assert torch.equal(leaf.grad, port_dropout.hw_dropout(g, 11, rate))


def test_hw_dropout_guards_and_sites_draw_their_own_seeds():
    x = torch.ones(64, 64)
    assert port_dropout.hw_dropout(x, 3, 0.0).equal(x)
    with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
        port_dropout.hw_dropout(x, 3, 1.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port_dropout.hw_dropout(torch.ones(4, device="meta"), 3, 0.1)
    # Two calls on one DropoutRng (two sites of a step) draw two masks; a
    # fresh DropoutRng from the same seed repeats them.
    rng = port_dropout.DropoutRng(9)
    first = port_dropout.dropout(x, rng, 0.5, impl="pallas")
    second = port_dropout.dropout(x, rng, 0.5, impl="pallas")
    assert not torch.equal(first, second)
    again = port_dropout.DropoutRng(9)
    assert torch.equal(port_dropout.dropout(x, again, 0.5, impl="pallas"),
                       first)
