"""The warm start from a reference torch checkpoint (``.pt``): the port's
copy of the converter (``videocad_tpu_torch/models/torch_checkpoint.py``)
against ``tools/convert_torch_checkpoint.py``, and ``Experiment`` with a
``state_dict`` that names a ``.pt`` against the JAX ``Experiment`` and the
torch oracle of ``tests/test_full_model_parity.py`` (the reference model
rebuilt from ``torch.nn``, in both vit_pytorch generations).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.convert_torch_checkpoint as tool
import videocad_tpu.experiment as jax_experiment
import videocad_tpu_torch.experiment as port_experiment
from tests.test_full_model_parity import B, IMG, MODEL_CONFIG, T, TorchRefModel
from videocad_tpu_torch.experiment import Experiment, load_warm_start
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.models import torch_checkpoint as port

GENERATIONS = {"modern": True, "legacy": False}
LEGACY = {"vit_patch_norm": False, "vit_final_norm": False}


def _oracle_state_dict(generation, prefix="module._orig_mod."):
    """A released checkpoint's state dict: the torch oracle's weights from
    seed 0, under the DDP and compile prefixes."""
    torch.manual_seed(0)
    oracle = TorchRefModel(GENERATIONS[generation]).eval()
    return oracle, {prefix + k: v for k, v in oracle.state_dict().items()}


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, IMG, IMG, 1)).astype(np.float32),
            (rng.integers(0, 1000, (B, T, 7)) / 1000.0).astype(np.float32),
            rng.standard_normal((B, IMG, IMG, 1)).astype(np.float32))


def _assert_trees_equal(got, want):
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype == np.float32, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("prefix", ["", "module.", "module._orig_mod."])
@pytest.mark.parametrize("generation", sorted(GENERATIONS))
def test_converter_copy_equals_the_tool(generation, prefix):
    _, sd = _oracle_state_dict(generation, prefix)
    assert port.strip_prefixes(sd).keys() == tool.strip_prefixes(sd).keys()
    overrides = port.detect_config_overrides(sd)
    assert overrides == tool.detect_config_overrides(sd)
    assert overrides == ({} if generation == "modern" else LEGACY)
    config = dict(MODEL_CONFIG, **overrides)
    _assert_trees_equal(port.convert_state_dict(sd, config),
                        tool.convert_state_dict(sd, config))
    bare = tool.strip_prefixes(sd)
    for name in ("state_embedding_model", "cad_embedding_model"):
        _assert_trees_equal(port.convert_vit(bare, name, 2),
                            tool.convert_vit(bare, name, 2))
    _assert_trees_equal(port.convert_decoder(bare, 2),
                        tool.convert_decoder(bare, 2))
    norm = "transformer_decoder.layers.0.norm1"
    _assert_trees_equal(port.linear(bare, "embed_state"),
                        tool.linear(bare, "embed_state"))
    _assert_trees_equal(port.layernorm(bare, norm), tool.layernorm(bare, norm))


@pytest.mark.parametrize("generation", sorted(GENERATIONS))
def test_reference_state_dict_inverts_the_converter(generation):
    """The inverse gives the oracle's own names and values back, and a port
    model's weights survive the round trip."""
    _, sd = _oracle_state_dict(generation, prefix="")
    config = dict(MODEL_CONFIG, **port.detect_config_overrides(sd))
    back = port.reference_state_dict(port.convert_state_dict(sd, config))
    assert sorted(back) == sorted(sd)
    for name, value in sd.items():
        np.testing.assert_array_equal(back[name], value.numpy(),
                                      err_msg=name)
    model = create_model(config, generator=torch.Generator().manual_seed(4))
    tree = jax_tree_from_state_dict(model.state_dict())
    _assert_trees_equal(port.convert_state_dict(
        port.reference_state_dict(tree), config), tree)


class _Recorder:
    """A trainer that keeps what the experiment built and trains nothing."""

    built = []

    def __init__(self, model, *args, params=None, **kwargs):
        self.built.append((model, params))

    def resume(self):
        pass

    def train(self, epochs):
        pass

    def evaluate(self, mode="test"):
        return {"mode": mode}


@pytest.mark.parametrize("generation", sorted(GENERATIONS))
def test_experiment_warm_starts_from_a_pt(generation, tmp_path, monkeypatch):
    """The port's Experiment folds the checkpoint's generation into the
    config before the model is built and params.json is written, and its
    model gives the JAX Experiment's float32 logits from the same file
    (1e-5) and the torch oracle's (within test_full_model_parity's
    tolerance)."""
    oracle, sd = _oracle_state_dict(generation)
    path = str(tmp_path / "best_model.pt")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    _Recorder.built = []
    monkeypatch.setattr(port_experiment, "Trainer", _Recorder)
    monkeypatch.setattr(jax_experiment, "Trainer", _Recorder)
    params = dict(MODEL_CONFIG, state_dict=path)
    training = {"epochs": 0}
    Experiment(None, None, None, training, device="cpu",
               log_dir=str(tmp_path / "port")).run_with_params(params, "ws")
    jax_experiment.Experiment(None, None, None, training,
                              log_dir=str(tmp_path / "jax")).run_with_params(
        params, "ws")
    (model, _), (jax_model, jax_params) = _Recorder.built
    expected = {} if generation == "modern" else LEGACY
    for key, value in expected.items():
        assert getattr(model.config, key) is value
    (run,) = os.listdir(tmp_path / "port")
    assert run.startswith("ws_")
    with open(tmp_path / "port" / run / "params.json") as f:
        saved = json.load(f)
    assert {k: saved.get(k) for k in expected} == expected
    assert saved["state_dict"] == path

    frames, actions, cad = _inputs()
    with torch.no_grad():
        got = model({"frames": torch.from_numpy(frames),
                     "actions": torch.from_numpy(actions),
                     "cad_image": torch.from_numpy(cad)})
        want_oracle = oracle(torch.from_numpy(frames).permute(0, 1, 4, 2, 3),
                             torch.from_numpy(actions),
                             torch.from_numpy(cad).permute(0, 3, 1, 2))
    want_jax = jax_model.apply(
        {"params": jax_params},
        {"frames": jnp.asarray(frames), "actions": jnp.asarray(actions),
         "cad_image": jnp.asarray(cad)})
    for g, w_jax, w_oracle in zip(got, want_jax, want_oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_jax), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), w_oracle.numpy(), atol=2e-4,
                                   rtol=1e-4)


def test_load_warm_start_takes_a_pt_of_the_models_generation(tmp_path):
    _, sd = _oracle_state_dict("legacy")
    path = str(tmp_path / "legacy.pt")
    torch.save(sd, path)                      # a bare state dict
    model = create_model(dict(MODEL_CONFIG, **LEGACY))
    load_warm_start(model, path)
    want = state_dict_from_jax(tool.convert_state_dict(
        sd, dict(MODEL_CONFIG, **LEGACY)))
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
    with pytest.raises(ValueError, match="another ViT generation"):
        load_warm_start(create_model(MODEL_CONFIG), path)
    assert not os.path.exists(tmp_path / "logs")
