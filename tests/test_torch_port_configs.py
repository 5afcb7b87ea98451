"""Every named config of the repo's ``model_configs/`` in the port against
the JAX package.

Each name of each ``model_configs/*.json`` builds in both packages, JAX
weights are carried into the port through ``state_dict_from_jax``, and the
float32 logits of one synthetic uint8 batch are compared. The vision tower
is cut (a 32² input, one block of width 32 for the ViT) and so is the
depth of the decoder and of the GPT-2 blocks (2); every other width, the
heads, the wiring flags, the encoder kind, the views and the model family
are the config's. Names that resolve to the same model are built once.

The GenCAD names keep ``vit_patch`` 32 and ``vit_attention_impl:
"fused"``: their CAD encoder sees a 256² edge image, T = 65 tokens, and
the JAX side runs its fused attention kernel in Pallas interpret mode
against the port's plain version (CPU tensors). A GenCAD and a
decision-transformer train step are held against ``videocad_tpu`` too.

Only the repo's ``model_configs/`` is read.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import JAX_LOSS, PORT_LOSS
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.models.resnet import ResNet18GN as JaxResNet
from videocad_tpu.ops.fused_attention import mhsa_short as jax_mhsa_short
from videocad_tpu.train import state as jax_state
from videocad_tpu.train import steps as jax_steps
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.models import (VideoCADFormerConfig, create_model,
                                       jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.models.resnet import ResNet18GN
from videocad_tpu_torch.ops import fused_attention as port_fused
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train import steps as port_steps

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "model_configs")
CUT = dict(image_size=32, vit_patch=16, vit_dim=32, vit_depth=1,
           vit_heads=2, vit_head_dim=16, vit_mlp_dim=32, dtype="float32",
           dropout=0.0, num_decoder_layers=2, n_layer=2)
# ResNet18-GN's GroupNorm: flax takes the variance as E[x^2] - E[x]^2,
# F.group_norm in two passes; over 17 normalised convolutions the logits
# drift by a few 1e-6 more than the ViT configs' (measured: 4e-6 at most).
ATOL, RESNET_ATOL = 1e-5, 2e-5


def _names():
    cases = []
    for fname in sorted(os.listdir(CONFIG_DIR)):
        if fname.endswith(".json"):
            with open(os.path.join(CONFIG_DIR, fname)) as f:
                cases += [(fname, name) for name in json.load(f)]
    return cases


NAMES = _names()


def _cut(config):
    cfg = dict(config, **CUT)
    if cfg.get("use_pretrained_cad_model"):
        # The CAD encoder at 256² / 32: 8 x 8 patches and the cls token.
        cfg["vit_patch"] = 32
    return cfg


def _key(cfg):
    extras = tuple(sorted((k, str(cfg.get(k))) for k in (
        "model_family", "n_layer", "n_head", "enable_image_conditioning")))
    return dataclasses.astuple(VideoCADFormerConfig.from_json(cfg)) + extras


def _batch(cfg, b=2, t=3, seed=0):
    """uint8 frames, CAD image (the 256² x 3 edge image under GenCAD) and
    views, normalized actions."""
    rng = np.random.default_rng(seed)
    size = cfg["image_size"]
    u8 = lambda *shape: rng.integers(0, 256, shape, dtype=np.uint8)  # noqa: E731
    acts = np.concatenate([rng.integers(0, 5, (b, t, 1)),
                           rng.integers(-1, 1000, (b, t, 6))], -1)
    batch = {"frames": u8(b, t, size, size, 3),
             "actions": (acts / np.asarray([4.0] + [1000.0] * 6)).astype(
                 np.float32),
             "cad_image": (u8(b, 256, 256, 3)
                           if cfg.get("use_pretrained_cad_model")
                           else u8(b, size, size, 3))}
    if cfg.get("num_views", 0):
        batch["multiview_images"] = u8(b, cfg["num_views"], size, size, 3)
    return batch


_BUILT = {}


def _logits(cfg):
    """(JAX logits, port logits, port model) of one build of ``cfg``."""
    key = _key(cfg)
    if key not in _BUILT:
        jax_model = jax_create_model(cfg)
        params = init_model(jax_model, jax.random.PRNGKey(0), batch=1,
                            seq_len=2)
        model = create_model(cfg)
        model.load_state_dict(state_dict_from_jax(params))   # strict
        batch = _batch(cfg)
        want = jax_model.apply({"params": params},
                               {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            got = model({k: torch.from_numpy(v) for k, v in batch.items()})
        _BUILT[key] = ([np.asarray(x) for x in want],
                       [x.numpy() for x in got], model)
    return _BUILT[key]


@pytest.mark.parametrize("fname,name", NAMES,
                         ids=[f"{f}:{n}" for f, n in NAMES])
def test_named_config_logits_match_jax(fname, name):
    with open(os.path.join(CONFIG_DIR, fname)) as f:
        cfg = _cut(json.load(f)[name])
    want, got, model = _logits(cfg)
    atol = RESNET_ATOL if cfg.get("encoder") == "resnet" else ATOL
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    if cfg.get("model_family") == "decision_transformer":
        assert type(model).__name__ == "DecisionTransformer"
    if cfg.get("use_pretrained_cad_model"):
        assert model.cad_encoder.pos_embedding.shape[1] == 65


def test_every_name_of_every_config_file_is_covered():
    assert len(NAMES) == 30
    assert {f for f, _ in NAMES} == {
        "autoregressive_transformer.json", "final_experiments.json",
        "transformer_experiments.json", "vid_pretrained.json"}


# ---- the parts: ResNet18-GN, the weight map, K1 at T past 64 ----

@pytest.mark.parametrize("size,channels", [(32, 1), (33, 3)])
def test_resnet18gn_embedding_and_gradients_match_jax(size, channels):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, channels)).astype(np.float32)
    jax_model = JaxResNet()
    params = jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    model = ResNet18GN(channels)
    model.load_state_dict(state_dict_from_jax(params))
    g = rng.standard_normal((2, 512)).astype(np.float32)

    def loss(p):
        return jnp.sum(jax_model.apply({"params": p}, jnp.asarray(x)) * g)

    want = jax_model.apply({"params": params}, jnp.asarray(x))
    want_grads = jax.grad(loss)(params)
    got = model(torch.from_numpy(x))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    (got * torch.from_numpy(g)).sum().backward()
    grads = jax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, w in flat_want.items():
        w = np.asarray(w)
        # 1e-4 of each tensor's largest entry.
        np.testing.assert_allclose(flat_got[path] / np.abs(w).max(),
                                   w / np.abs(w).max(), atol=1e-4, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["default_params", "base_model"])
def test_resnet_and_dt_trees_round_trip_through_the_state_dict(name):
    fname = ("vid_pretrained.json" if name == "base_model"
             else "autoregressive_transformer.json")
    with open(os.path.join(CONFIG_DIR, fname)) as f:
        cfg = _cut(json.load(f)[name])
    params = init_model(jax_create_model(cfg), jax.random.PRNGKey(2),
                        batch=1, seq_len=2)
    sd = state_dict_from_jax(params)
    kernel = np.asarray(params["cad_encoder"]["stem_conv"]["kernel"])
    assert kernel.shape == (7, 7, 1, 64)                      # HWIO
    assert tuple(sd["cad_encoder.stem_conv.weight"].shape) == (64, 1, 7, 7)
    assert "cad_encoder.stage1_block0.downsample_gn.weight" in sd
    if name == "base_model":
        assert tuple(sd["embed_timestep.weight"].shape) == (1000, 256)
        assert "h_1.attn.key.weight" in sd and "predict_action.bias" in sd
    back = jax_tree_from_state_dict(sd)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=str(path))
    again = state_dict_from_jax(back)
    assert sorted(again) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(again[key], value), key


@pytest.mark.parametrize("t", [65, 128])
def test_k1_plain_versions_past_64_match_jax_interpret(t):
    """The port's plain K1 at the wide instantiation's T against JAX
    mhsa_short (Pallas interpret mode), forward and gradients, f32."""
    heads, d, b = 2, 16, 2
    rng = np.random.default_rng(t)
    q, k, v, g = (rng.standard_normal((b, t, heads * d)).astype(np.float32)
                  for _ in range(4))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jax_mhsa_short(jq, jk, jv, jnp.int32(0), heads, 0.0)
    want_grads = jax.grad(lambda *a: jnp.sum(jax_mhsa_short(
        *a, jnp.int32(0), heads, 0.0) * jnp.asarray(g)), argnums=(0, 1, 2))(
        jq, jk, jv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = port_fused.mhsa_short(*leaves, None, heads)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    got.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=2e-5, rtol=0)


# ---- train steps: GenCAD (the CAD encoder frozen) and the DT ----

TRAIN_NAMES = {
    "gencad": ("transformer_experiments.json",
               "cad_past_10_actions_and_states_gencad"),
    "decision_transformer": ("vid_pretrained.json", "base_model"),
}


def _train_pair(kind):
    fname, name = TRAIN_NAMES[kind]
    with open(os.path.join(CONFIG_DIR, fname)) as f:
        cfg = _cut(json.load(f)[name])
    freeze = bool(cfg.get("use_pretrained_cad_model"))
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(3), batch=1, seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    tc = {"lr": 1e-3}
    jax_st, jax_tx = jax_state.create_train_state(params, tc, freeze)
    port_st = port_state.create_train_state(dict(model.named_parameters()),
                                            tc, freeze)
    data = port_synthetic.synthetic_batch_feed(2, 6, image_size=32, seed=5)
    if freeze:
        data["cad_image"] = np.random.default_rng(6).integers(
            0, 256, (2, 256, 256, 3), dtype=np.uint8)
    batch = ({k: jnp.asarray(v) for k, v in data.items()},
             {k: torch.from_numpy(v) for k, v in data.items()})
    return jax_model, jax_st, jax_tx, model, port_st, batch


def _assert_params_close(model, jax_params, steps):
    """The port's parameters against JAX's after ``steps`` Adam steps at lr
    1e-3: within 1e-5, but for a share below 1e-4 of the entries, held to
    2e-4. Adam divides an entry's gradient by its running magnitude, so an
    entry whose gradient is near Adam's eps (1e-8), where the two
    packages' rounding differs in relative terms, moves by a different
    fraction of lr (one step moves an entry by up to 1e-3). At these widths
    (1,024-wide decoders, ResNet convolutions with GroupNorm's two variance
    formulas) a few hundred of the millions of entries are such (measured:
    up to 1.1e-4); a key bias, whose gradient is noise, by up to lr a
    step."""
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax_tree_from_state_dict(model.state_dict())))
    want = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    assert sorted(map(str, got)) == sorted(map(str, want))
    loose = total = 0
    for path, w in want.items():
        diff = np.abs(got[path] - np.asarray(w))
        names = [getattr(p, "key", None) for p in path]
        bound = 2e-3 * steps if names[-2:] == ["key", "bias"] else 2e-4
        assert diff.max() <= bound, (str(path), diff.max())
        loose += int((diff > 1e-5).sum())
        total += diff.size
    assert loose <= 1e-4 * total, (loose, total)


@pytest.mark.parametrize("kind", sorted(TRAIN_NAMES))
def test_train_steps_match_jax(kind):
    """The loss of each of three steps, the parameters after 1 and 3 steps,
    and under GenCAD a CAD encoder that the zero learning rate keeps."""
    jax_model, jax_st, jax_tx, model, port_st, batch = _train_pair(kind)
    jax_step = jax.jit(jax_steps.make_train_step(jax_model, jax_tx, JAX_LOSS))
    port_step = port_steps.make_train_step(model, PORT_LOSS)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for step in range(3):
        jax_st, want_loss, _ = jax_step(jax_st, batch[0],
                                        jax.random.PRNGKey(0))
        port_st, loss, _ = port_step(port_st, batch[1], 0)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
        if step in (0, 2):
            _assert_params_close(model, jax_st.params, step + 1)
    after = model.state_dict()
    cad = [k for k in before if k.startswith("cad_encoder.")]
    frozen = all(torch.equal(after[k], before[k]) for k in cad)
    assert cad and frozen == (kind == "gencad")
    assert not torch.equal(after["predict_cmd.weight"],
                           before["predict_cmd.weight"])
