"""The PyTorch port's ops against the JAX package, plus the port's guards.

Inputs are made with numpy from a seed and fed to both packages. The JAX
fused attention runs its Pallas kernel in interpret mode, as
tests/test_fused_attention.py runs it on the CPU.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocad_tpu.actions import ops as jax_action_ops
from videocad_tpu.actions import vocab as jax_vocab
from videocad_tpu.ops import fused_attention as jax_fused
from videocad_tpu.ops import preprocess as jax_preprocess
from videocad_tpu_torch.actions import ops as port_action_ops
from videocad_tpu_torch.actions import vocab as port_vocab
from videocad_tpu_torch.cli import serve as port_serve
from videocad_tpu_torch.models import create_model, flagship_config
from videocad_tpu_torch.ops import fused_attention as port_fused
from videocad_tpu_torch.ops import preprocess as port_preprocess
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
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


def test_mhsa_short_on_cpu_runs_the_plain_version_and_launches_nothing(
        monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 50, 1024, seed=7))
    monkeypatch.setattr(port_fused.mhsa_short, "launches", 0)
    got = port_fused.mhsa_short(q, k, v, 16)
    assert port_fused.mhsa_short.launches == 0
    torch.testing.assert_close(
        got, port_fused.mhsa_short_reference(q, k, v, 16), rtol=0, atol=0)


def test_mhsa_short_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 32, seed=1))
    with pytest.raises(ValueError):
        port_fused.mhsa_short(q, k[:, :4], v, 2)
    with pytest.raises(ValueError):
        port_fused.mhsa_short(q, k, v, 3)
    with pytest.raises(NotImplementedError, match="K1-bwd"):
        port_fused.mhsa_short(q, k, v, 2, dropout_rate=0.1)


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
    with pytest.raises(NotImplementedError, match="K2"):
        port_preprocess.maybe_preprocess(
            torch.zeros((1, 4, 4, 3), dtype=torch.uint8), impl="pallas")


def test_resize_matrix_equals_jax():
    for n_in, n_out in [(20, 16), (256, 224), (7, 9)]:
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
             "ACTION_PARAM_MASK", "KEY3_WINDOW_LO", "KEY3_WINDOW_HI"]
    for name in names:
        assert getattr(port_vocab, name) == getattr(jax_vocab, name), name


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import videocad_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            videocad_tpu_torch.__path__, "videocad_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "videocad_tpu"))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_serve_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_serve.parse_args(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_engine(args)
    with pytest.raises(NotImplementedError, match="slice 10"):
        port_serve.build_engine(port_serve.parse_args(
            ["--device", "cpu", "--artifact", "x.vcdx"]))


@pytest.mark.parametrize("override,item", [
    ({"vit_attention_impl": "block"}, "K6"),
    ({"vit_mlp_impl": "block"}, "K6"),
    ({"ln_impl": "pallas"}, "K4"),
    ({"attention_impl": "pallas"}, "K3"),
    ({"preprocess_impl": "pallas"}, "K2"),
    ({"dropout_impl": "pallas"}, "K5"),
    ({"quant": "int8"}, "slice 11"),
])
def test_unported_options_raise(override, item):
    with pytest.raises(NotImplementedError, match=item):
        create_model(dict(TINY_CONFIG, **override))


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
