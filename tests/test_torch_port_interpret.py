"""The port's interpretability tools against the JAX package.

The ViT's returned attention weights (JAX's sowed ``attention_weights``),
the attention rollout and the CAD saliency of ``infer/interpret.py``, on
the same weights (``state_dict_from_jax``) and numpy-seeded inputs; float32,
a tiny config (hidden 64, image 32, a ViT of two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG, synthetic_batch
from videocad_tpu.infer.interpret import attention_rollout as jax_rollout
from videocad_tpu.infer.interpret import cad_saliency as jax_saliency
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.models.vit import ViT as JaxViT
from videocad_tpu.models.vit import ViTConfig as JaxViTConfig
from videocad_tpu_torch.infer.interpret import (attention_rollout,
                                                cad_saliency)
from videocad_tpu_torch.models import create_model, state_dict_from_jax

CFG = dict(TINY_CONFIG, hidden_size=64, dim_feedforward=64, vit_depth=2)


@pytest.fixture(scope="module")
def pair():
    jax_model = jax_create_model(CFG)
    params = init_model(jax_model, jax.random.PRNGKey(31), batch=1,
                        seq_len=2)
    return jax_model, params, state_dict_from_jax(params)


def _port(state, **impls):
    model = create_model(dict(CFG, **impls))
    model.load_state_dict(state)
    return model


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _jax_weights(params, cad):
    cfg = jax_create_model(CFG).config
    vit = JaxViT(JaxViTConfig(
        image_size=cfg.image_size, patch_size=cfg.vit_patch,
        dim=cfg.vit_dim, depth=cfg.vit_depth, heads=cfg.vit_heads,
        head_dim=cfg.vit_head_dim, mlp_dim=cfg.vit_mlp_dim,
        channels=cfg.image_channels, dropout=0.0, emb_dropout=0.0),
        sow_attention=True)
    emb, state = vit.apply({"params": params["cad_encoder"]},
                           jnp.asarray(cad), True, mutable=["intermediates"])
    inter = state["intermediates"]
    return emb, np.stack([np.asarray(
        inter[f"block_{i}"]["attn"]["attention_weights"][0])
        for i in range(cfg.vit_depth)])


@pytest.mark.parametrize("impl", ["xla", "fused", "pallas", "block"])
def test_vit_returned_weights_equal_jax_sowed_weights(pair, impl):
    """return_attention runs the plain core whatever vit_attention_impl is
    and returns (depth, B, H, N, N) float32 weights: JAX's sowed ones."""
    _, params, state = pair
    model = _port(state, vit_attention_impl=impl)
    cad = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 1)).astype(
        np.float32)
    want_emb, want = _jax_weights(params, cad)
    with torch.no_grad():
        emb, weights = model.cad_encoder(torch.from_numpy(cad),
                                         return_attention=True)
    assert weights.dtype == torch.float32
    assert tuple(weights.shape) == (2, 2, 2, 5, 5)
    np.testing.assert_allclose(weights.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), atol=1e-5,
                               rtol=0)


def test_default_path_is_unchanged(pair):
    """Without return_attention the ViT and the model take their paths as
    before: the plain path's embedding is bit-equal to the one the
    returned-weights path computes, and the logits are JAX's."""
    jax_model, params, state = pair
    model = _port(state)
    cad = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model.cad_encoder(cad),
                           model.cad_encoder(cad, return_attention=True)[0])
    data = synthetic_batch(np.random.default_rng(3), 2, 4, image_size=32)
    data.pop("timesteps")
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    want = jax_model.apply({"params": params},
                           {k: jnp.asarray(v) for k, v in data.items()},
                           deterministic=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("discard_ratio", [0.0, 0.5])
@pytest.mark.parametrize("output_size", [None, 48])
def test_attention_rollout_equals_jax(pair, discard_ratio, output_size):
    jax_model, params, state = pair
    model = _port(state, vit_attention_impl="fused")
    cad = _uint8((2, 32, 32, 3), seed=4)
    want = jax_rollout(jax_model, params, jnp.asarray(cad),
                       discard_ratio=discard_ratio, output_size=output_size)
    got = attention_rollout(model, torch.from_numpy(cad),
                            discard_ratio=discard_ratio,
                            output_size=output_size)
    size = output_size or 32
    assert tuple(got.shape) == (2, size, size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("target_class", [None, 3])
def test_cad_saliency_equals_jax(pair, target_class):
    """The gradient through the fused ViT attention's plain version (the
    JAX model on its XLA core), within 1e-4 of the largest entry; autograd
    runs under torch.no_grad() too, and the parameters keep no grad."""
    jax_model, params, state = pair
    model = _port(state, vit_attention_impl="fused")
    data = synthetic_batch(np.random.default_rng(5), 2, 4, image_size=32)
    data["cad_image"] = _uint8((2, 32, 32, 3), seed=6)
    cad_w, want = jax_saliency(jax_model, params,
                               {k: jnp.asarray(v) for k, v in data.items()},
                               target_class=target_class)
    with torch.no_grad():
        cad, got = cad_saliency(model, {k: torch.from_numpy(v)
                                        for k, v in data.items()},
                                target_class=target_class)
    assert tuple(got.shape) == (2, 32, 32)
    np.testing.assert_allclose(cad.numpy(), np.asarray(cad_w), atol=1e-6)
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    assert all(p.grad is None for p in model.parameters())
