"""The PyTorch port's model and rollout against the JAX package.

Weights come from the JAX ``init_model`` and are carried into the port
through ``state_dict_from_jax``; inputs are made with numpy from a seed.
The tiny config runs the ViT attention through the fused kernel: the JAX
side runs its Pallas kernel in interpret mode, the port its plain version
(CPU tensors). Everything is float32.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.infer.export import _flatten_params
from videocad_tpu.infer.rollout import sequential_inference as jax_rollout
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.models.videocadformer import VideoCADFormer as JaxModel
from videocad_tpu_torch.infer.rollout import sequential_inference
from videocad_tpu_torch.models import (create_model, init_params,
                                       jax_tree_from_state_dict,
                                       load_jax_params, state_dict_from_jax)

FUSED = dict(TINY_CONFIG, vit_attention_impl="fused")
WIRINGS = {
    "actions_and_states": {},
    "states_only": {"enable_past_actions": False},
    "cad_only": {"enable_past_actions": False, "enable_past_states": False,
                 "enable_timestep_embedding": False},
}


def _pair(overrides=None, seed=0):
    cfg = dict(FUSED, **(overrides or {}))
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(seed), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, params, model


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _actions(b, t, seed):
    rng = np.random.default_rng(seed)
    acts = np.concatenate([rng.integers(0, 5, (b, t, 1)),
                           rng.integers(-1, 1000, (b, t, 6))], -1)
    return (acts / np.asarray([4.0] + [1000.0] * 6)).astype(np.float32)


def test_state_dict_follows_the_jax_tree():
    _, params, model = _pair()
    converted = state_dict_from_jax(params)
    ours = model.state_dict()
    assert sorted(converted) == sorted(ours)
    assert "decoder.layers_1.cross_attn.key.weight" in ours
    assert "timestep_embedding.weight" in ours
    for key, value in converted.items():
        assert value.shape == ours[key].shape, key
    kernel = np.asarray(params["decoder"]["layers_0"]["linear1"]["kernel"])
    np.testing.assert_array_equal(
        ours["decoder.layers_0.linear1.weight"].numpy(), kernel.T)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_jax_tree_round_trips_through_the_state_dict(wiring):
    _, params, model = _pair(WIRINGS[wiring], seed=1)
    back = jax_tree_from_state_dict(model.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=str(path))
    again = state_dict_from_jax(back)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


def test_init_params_is_seeded_and_has_flax_statistics():
    cfg = dict(FUSED, hidden_size=64, dim_feedforward=64)
    a = create_model(cfg, generator=torch.Generator().manual_seed(3))
    b = init_params(create_model(cfg),
                    torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    sd = a.state_dict()
    w = sd["decoder.layers_0.linear1.weight"]               # fan_in 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.2 * 64 ** -0.5
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
    assert torch.count_nonzero(sd["decoder.layers_0.linear1.bias"]) == 0
    assert torch.all(sd["decoder.layers_0.norm1.weight"] == 1)
    assert abs(sd["state_encoder.pos_embedding"].std().item() - 0.02) < 0.005


def test_vit_embedding_matches_jax():
    jax_model, params, model = _pair()
    frames = _u8((2, 3, 32, 32, 3), seed=1)
    expected = jax_model.apply({"params": params}, jnp.asarray(frames),
                               method=JaxModel.encode_frames)
    with torch.no_grad():
        got = model.encode_frames(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_forward_logits_match_jax(wiring):
    jax_model, params, model = _pair(WIRINGS[wiring], seed=2)
    b, t = 2, 5
    inputs = {"frames": _u8((b, t, 32, 32, 3), seed=3),
              "cad_image": _u8((b, 32, 32, 3), seed=4),
              "actions": _actions(b, t, seed=5)}
    expected = jax_model.apply({"params": params},
                               {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("wiring,action", [("actions_and_states", True),
                                           ("actions_and_states", False),
                                           ("states_only", True)])
def test_sequential_inference_matches_jax_step_for_step(wiring, action):
    jax_model, params, model = _pair(WIRINGS[wiring], seed=6)
    frames = _u8((2, 6, 32, 32, 3), seed=7)
    cad = _u8((2, 32, 32, 3), seed=8)
    expected = jax_rollout(jax_model, params, jnp.asarray(frames),
                           jnp.asarray(cad), action=action)
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad), action=action)
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


def test_rollout_refuses_unported_weight_quant():
    _, _, model = _pair()
    with pytest.raises(NotImplementedError, match="slice 7"):
        sequential_inference(model, torch.zeros((1, 2, 32, 32, 3),
                                                dtype=torch.uint8),
                             torch.zeros((1, 32, 32, 3), dtype=torch.uint8),
                             weight_quant="int8")


def test_load_jax_params_reads_npz_and_vcdx(tmp_path):
    _, params, model = _pair(seed=9)
    flat = _flatten_params(params)
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    vcdx = tmp_path / "model.vcdx"
    with zipfile.ZipFile(vcdx, "w") as zf:
        zf.writestr("params.npz", buf.getvalue())
        zf.writestr("config.json", json.dumps(FUSED))
    want = state_dict_from_jax(params)
    for path, config in [(npz, None), (vcdx, FUSED)]:
        tree, got_config = load_jax_params(str(path))
        assert got_config == config
        got = state_dict_from_jax(tree)
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    model.load_state_dict(state_dict_from_jax(load_jax_params(str(npz))[0]))


# ---- ln_impl / dropout_impl "pallas" ----

def test_ln_impl_pallas_logits_match_jax_and_the_plain_layernorm():
    """The tiny config with the fused LayerNorm: the JAX side runs its
    Pallas kernel in interpret mode, the port its plain version; 1e-4 at
    float32 against JAX (as the default path is held), 1e-5 against the
    port under ln_impl "xla" with the same weights."""
    impls = {"ln_impl": "pallas", "dropout_impl": "pallas"}
    jax_model, params, model = _pair(impls, seed=6)
    plain = create_model(FUSED)
    plain.load_state_dict(model.state_dict())     # the same names either way
    assert list(model.state_dict()) == list(plain.state_dict())
    assert sorted(state_dict_from_jax(params)) == sorted(model.state_dict())
    b, t = 2, 5
    inputs = {"frames": _u8((b, t, 32, 32, 3), seed=7),
              "cad_image": _u8((b, 32, 32, 3), seed=8),
              "actions": _actions(b, t, seed=9)}
    expected = jax_model.apply({"params": params},
                               {k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        tensors = {k: torch.from_numpy(v) for k, v in inputs.items()}
        got = model(tensors)
        want_plain = plain(tensors)
    for g, e, w in zip(got, expected, want_plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_ln_impl_pallas_uses_the_fused_layernorm_in_the_vit_only():
    from videocad_tpu_torch.models.layers import LayerNorm
    from videocad_tpu_torch.models.vit import FusedLayerNorm

    model = create_model(dict(FUSED, ln_impl="pallas"))
    fused = [n for n, m in model.named_modules()
             if isinstance(m, FusedLayerNorm)]
    plain = [n for n, m in model.named_modules() if isinstance(m, LayerNorm)]
    # 3 + 2 per block in each of the two encoders; the decoder's stay.
    assert len(fused) == 2 * (3 + 2 * FUSED["vit_depth"])
    assert all(n.split(".")[0] in ("state_encoder", "cad_encoder")
               for n in fused)
    assert plain and all(n.startswith("decoder.") for n in plain)
    with pytest.raises(ValueError, match="unknown ln_impl"):
        create_model(dict(FUSED, ln_impl="mosaic"))
