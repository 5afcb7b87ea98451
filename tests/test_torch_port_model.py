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


@pytest.mark.parametrize("window,seq_len,action", [
    (10, 5, True),     # T below the window: the window clamps to T
    (10, 5, False),
    (3, 7, False),     # no action fed back past the window
])
def test_sequential_inference_short_horizon_and_no_feedback_match_jax(
        window, seq_len, action):
    jax_model, params, model = _pair(dict(window_size=window), seed=17)
    frames = _u8((2, seq_len, 32, 32, 3), seed=18)
    cad = _u8((2, 32, 32, 3), seed=19)
    expected = jax_rollout(jax_model, params, jnp.asarray(frames),
                           jnp.asarray(cad), action=action)
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad), action=action)
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


ROLLOUT_CFGS = {
    # decode loop: the views' stream in the memory
    "multiview": (dict(num_views=2), True),
    # decode loop: the GenCAD CAD encoder (T = 65)
    "gencad": (dict(use_pretrained_cad_model=True, vit_patch=32), True),
    # one pass: ResNet encoders, views, no action feedback
    "resnet_multiview": (dict(encoder="resnet", num_views=3,
                              enable_past_actions=False,
                              enable_past_states=False), False),
}


@pytest.mark.parametrize("kind", sorted(ROLLOUT_CFGS))
def test_sequential_inference_with_views_gencad_resnet_matches_jax(kind):
    overrides, feedback = ROLLOUT_CFGS[kind]
    jax_model, params, model = _pair(overrides, seed=10)
    assert model.config.enable_past_actions == feedback
    frames = _u8((2, 5, 32, 32, 3), seed=11)
    cad = _u8((2, 256, 256, 3) if "gencad" in kind else (2, 32, 32, 3),
              seed=12)
    views = (_u8((2, model.config.num_views, 32, 32, 3), seed=13)
             if model.config.num_views else None)
    expected = jax_rollout(jax_model, params, jnp.asarray(frames),
                           jnp.asarray(cad), multiview_images=None
                           if views is None else jnp.asarray(views))
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad), multiview_images=None
                               if views is None else torch.from_numpy(views))
    for g, e in zip(got, expected):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-4,
                                   rtol=0)


def test_decision_transformer_rollout_is_its_one_pass_forward():
    """No action feedback: the rollout is the teacher-forced forward with
    zero actions, as in JAX, for the decision transformer too."""
    cfg = dict(FUSED, model_family="decision_transformer", n_layer=2,
               n_head=4, enable_past_actions=False)
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(14), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    frames, cad = _u8((2, 4, 32, 32, 3), seed=15), _u8((2, 32, 32, 3), 16)
    expected = jax_rollout(jax_model, params, jnp.asarray(frames),
                           jnp.asarray(cad))
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad))
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=0)
    with torch.no_grad():
        actions = model({"frames": torch.from_numpy(frames),
                         "cad_image": torch.from_numpy(cad),
                         "actions": torch.zeros(2, 4, 7)}, continuous=True)
    want = jax_model.apply({"params": params},
                           {"frames": jnp.asarray(frames),
                            "cad_image": jnp.asarray(cad),
                            "actions": jnp.zeros((2, 4, 7))},
                           continuous=True)
    np.testing.assert_allclose(actions.numpy(), np.asarray(want), atol=1e-5)


def test_rollout_refuses_unported_weight_quant():
    """int8 and int4 are ported (tests/test_torch_port_quant_decode.py); a
    mode that neither package has is refused, as JAX's export refuses it."""
    _, _, model = _pair()
    with pytest.raises(ValueError, match="unknown weight_quant"):
        sequential_inference(model, torch.zeros((1, 2, 32, 32, 3),
                                                dtype=torch.uint8),
                             torch.zeros((1, 32, 32, 3), dtype=torch.uint8),
                             weight_quant="int2")


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


# ---- attention_impl "pallas" ----

@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_attention_impl_pallas_logits_match_jax_and_the_plain_attention(
        wiring):
    """The decoder's attention through flash attention: the JAX side runs
    its Pallas kernel in interpret mode, the port its plain version, fed
    the masks by index; 1e-4 at float32 against JAX under the same setting
    (as the default path is held), 1e-5 against the port under
    attention_impl "xla" with the same weights."""
    impls = dict(WIRINGS[wiring], attention_impl="pallas")
    jax_model, params, model = _pair(impls, seed=10)
    plain = create_model(dict(FUSED, **WIRINGS[wiring]))
    plain.load_state_dict(model.state_dict())     # the same names either way
    b, t = 2, 7
    inputs = {"frames": _u8((b, t, 32, 32, 3), seed=11),
              "cad_image": _u8((b, 32, 32, 3), seed=12),
              "actions": _actions(b, t, seed=13)}
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


def test_attention_impl_pallas_feeds_the_decoder_masks_by_index(monkeypatch):
    """Under "pallas" every decoder attention site calls flash_attention
    with a BandMask (causal for the self-attention, the window for the
    cross-attention), never a mask tensor; the ViT's attention stays on
    its own kernel."""
    from videocad_tpu_torch.models import layers
    from videocad_tpu_torch.ops.attention import BandMask

    seen = []
    real = layers.flash_attention

    def spy(q, k, v, mask=None, seed=None, dropout_rate=0.0):
        seen.append((mask, seed, dropout_rate))
        return real(q, k, v, mask, seed, dropout_rate)

    monkeypatch.setattr(layers, "flash_attention", spy)
    model = create_model(dict(FUSED, attention_impl="pallas"))
    t = 6
    with torch.no_grad():
        model({"frames": torch.from_numpy(_u8((1, t, 32, 32, 3), seed=1)),
               "cad_image": torch.from_numpy(_u8((1, 32, 32, 3), seed=2)),
               "actions": torch.from_numpy(_actions(1, t, seed=3))})
    window = FUSED["window_size"]
    assert [m for m, _, _ in seen] == [
        BandMask(t, t), BandMask(t, t, window)] * FUSED["num_decoder_layers"]
    assert all(seed is None and rate == 0.0 for _, seed, rate in seen)
    # In train() mode with dropout on, each site draws a seed of its own.
    seen.clear()
    from videocad_tpu_torch.ops.dropout import DropoutRng
    model = create_model(dict(FUSED, attention_impl="pallas", dropout=0.1))
    model.train()
    model({"frames": torch.from_numpy(_u8((1, t, 32, 32, 3), seed=1)),
           "cad_image": torch.from_numpy(_u8((1, 32, 32, 3), seed=2)),
           "actions": torch.from_numpy(_actions(1, t, seed=3))},
          rng=DropoutRng(0, "cpu"))
    seeds = [seed for _, seed, _ in seen]
    assert len(set(seeds)) == len(seeds) == 2 * FUSED["num_decoder_layers"]
    assert all(rate == 0.1 for _, _, rate in seen)


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_vit_attention_impl_pallas_logits_match_jax_and_xla(wiring):
    """The ViT's attention core through flash attention, unmasked
    (vit_attention_impl "pallas"): the JAX side runs its Pallas kernel in
    interpret mode, the port its plain version; 1e-4 at float32 against JAX
    under the same setting, 1e-5 against the port under "xla" with the same
    weights."""
    impls = dict(WIRINGS[wiring], vit_attention_impl="pallas", vit_depth=2)
    jax_model, params, model = _pair(impls, seed=18)
    plain = create_model(dict(FUSED, **WIRINGS[wiring], vit_depth=2,
                              vit_attention_impl="xla"))
    plain.load_state_dict(model.state_dict())     # the same names either way
    b, t = 2, 5
    inputs = {"frames": _u8((b, t, 32, 32, 3), seed=19),
              "cad_image": _u8((b, 32, 32, 3), seed=20),
              "actions": _actions(b, t, seed=21)}
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


def test_vit_attention_impl_pallas_calls_flash_attention_unmasked(
        monkeypatch):
    """Under vit_attention_impl "pallas" each ViT block of both encoders
    calls flash_attention once, without a mask, and mhsa_short never; in
    train() mode with dropout on each call draws a seed of its own."""
    from videocad_tpu_torch.models import layers
    from videocad_tpu_torch.ops.dropout import DropoutRng

    seen = []
    real = layers.flash_attention

    def spy(q, k, v, mask=None, seed=None, dropout_rate=0.0):
        seen.append((q.shape, mask, seed, dropout_rate))
        return real(q, k, v, mask, seed, dropout_rate)

    monkeypatch.setattr(layers, "flash_attention", spy)
    monkeypatch.setattr(layers, "mhsa_short", None)   # must not be called
    cfg = dict(FUSED, vit_attention_impl="pallas", vit_depth=2)
    t = 4
    inputs = {"frames": torch.from_numpy(_u8((1, t, 32, 32, 3), seed=1)),
              "cad_image": torch.from_numpy(_u8((1, 32, 32, 3), seed=2)),
              "actions": torch.from_numpy(_actions(1, t, seed=3))}
    with torch.no_grad():
        create_model(cfg)(inputs)
    tokens = (32 // FUSED["vit_patch"]) ** 2 + 1
    heads = (FUSED["vit_heads"], FUSED["vit_head_dim"])
    assert [s for s, _, _, _ in seen] == (
        [(t, tokens, *heads)] * 2 + [(1, tokens, *heads)] * 2)
    assert all(m is None and seed is None and rate == 0.0
               for _, m, seed, rate in seen)
    seen.clear()
    model = create_model(dict(cfg, dropout=0.1))
    model.train()
    model(inputs, rng=DropoutRng(0, "cpu"))
    seeds = [seed for _, _, seed, _ in seen]
    assert len(seeds) == 4 and len(set(seeds)) == 4
    assert all(rate == 0.1 for _, _, _, rate in seen)


# ---- vit_attention_impl / vit_mlp_impl "block" ----

BLOCK_SETTINGS = {
    "block": {"vit_attention_impl": "block"},
    "fused_attention_block_mlp": {"vit_attention_impl": "fused",
                                  "vit_mlp_impl": "block"},
    "block_with_pallas": {"vit_attention_impl": "block", "ln_impl": "pallas",
                          "dropout_impl": "pallas",
                          "attention_impl": "pallas"},
}


@pytest.mark.parametrize("setting", sorted(BLOCK_SETTINGS))
def test_block_impl_logits_match_jax_and_the_unfused_path(setting):
    """The tiny config (depth 2) with the ViT through the fused sub-block
    kernels: the JAX side runs its Pallas kernels in interpret mode, the
    port its plain versions; 1e-4 at float32 against JAX under the same
    setting (as the default path is held), 1e-5 against the port under
    "fused" with the same weights."""
    impls = dict(BLOCK_SETTINGS[setting], vit_depth=2)
    jax_model, params, model = _pair(impls, seed=14)
    plain = create_model(dict(FUSED, vit_depth=2))
    plain.load_state_dict(model.state_dict())     # the same names either way
    assert list(model.state_dict()) == list(plain.state_dict())
    b, t = 2, 5
    inputs = {"frames": _u8((b, t, 32, 32, 3), seed=15),
              "cad_image": _u8((b, 32, 32, 3), seed=16),
              "actions": _actions(b, t, seed=17)}
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


@pytest.mark.parametrize("setting,attn_calls,mlp_calls", [
    ("block", 2 * 2, 2 * 2), ("fused_attention_block_mlp", 0, 2 * 2)])
def test_block_impl_calls_the_fused_sub_blocks(monkeypatch, setting,
                                               attn_calls, mlp_calls):
    """Two encoders of depth 2: "block" sends every sub-block through
    attn_block and mlp_block and none through mhsa_short; "fused" with
    vit_mlp_impl "block" keeps mhsa_short and sends the MLPs through
    mlp_block. In train() mode each call draws a seed of its own."""
    from videocad_tpu_torch.models import layers, vit
    from videocad_tpu_torch.ops.dropout import DropoutRng

    seen = {"attn": [], "mlp": [], "mhsa": []}
    real_attn, real_mlp, real_mhsa = (vit.attn_block, vit.mlp_block,
                                      layers.mhsa_short)

    def spy_attn(x, *args):
        seen["attn"].append(args[7:])       # seed, heads, rate, eps
        return real_attn(x, *args)

    def spy_mlp(x, *args):
        seen["mlp"].append(args[6:])        # seed, rate, eps
        return real_mlp(x, *args)

    def spy_mhsa(*args):
        seen["mhsa"].append(args[3:])
        return real_mhsa(*args)

    monkeypatch.setattr(vit, "attn_block", spy_attn)
    monkeypatch.setattr(vit, "mlp_block", spy_mlp)
    monkeypatch.setattr(layers, "mhsa_short", spy_mhsa)
    cfg = dict(FUSED, vit_depth=2, dropout=0.1, **BLOCK_SETTINGS[setting])
    model = create_model(cfg)
    inputs = {"frames": torch.from_numpy(_u8((1, 4, 32, 32, 3), seed=1)),
              "cad_image": torch.from_numpy(_u8((1, 32, 32, 3), seed=2)),
              "actions": torch.from_numpy(_actions(1, 4, seed=3))}
    model.eval()
    with torch.no_grad():
        model(inputs)
    assert len(seen["attn"]) == attn_calls and len(seen["mlp"]) == mlp_calls
    assert len(seen["mhsa"]) == (0 if attn_calls else 2 * 2)
    assert all(a[0] is None and a[2] == 0.0 for a in seen["attn"])
    assert all(m[0] is None and m[1] == 0.0 for m in seen["mlp"])
    for calls in seen.values():
        calls.clear()
    model.train()
    model(inputs, rng=DropoutRng(0, "cpu"))
    seeds = [a[0] for a in seen["attn"]] + [m[0] for m in seen["mlp"]]
    assert len(seeds) == attn_calls + mlp_calls == len(set(seeds))
    assert all(a[2] == 0.1 for a in seen["attn"])
    assert all(m[1] == 0.1 for m in seen["mlp"])


def test_a_state_dict_saved_under_fused_loads_under_block(tmp_path):
    fused = create_model(dict(FUSED, vit_depth=2),
                         generator=torch.Generator().manual_seed(5))
    path = tmp_path / "fused.pt"
    torch.save(fused.state_dict(), path)
    inputs = {"frames": torch.from_numpy(_u8((1, 4, 32, 32, 3), seed=1)),
              "cad_image": torch.from_numpy(_u8((1, 32, 32, 3), seed=2)),
              "actions": torch.from_numpy(_actions(1, 4, seed=3))}
    with torch.no_grad():
        want = fused(inputs)
    for setting in BLOCK_SETTINGS.values():
        block = create_model(dict(FUSED, vit_depth=2, **setting))
        missing = block.load_state_dict(torch.load(path), strict=True)
        assert not missing.missing_keys and not missing.unexpected_keys
        with torch.no_grad():
            got = block(inputs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                       rtol=0)
        # And back.
        again = create_model(dict(FUSED, vit_depth=2))
        again.load_state_dict(block.state_dict())
