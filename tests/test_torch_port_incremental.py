"""The port's incremental (frame-at-a-time) decode against the JAX package.

After ``tests/test_incremental_decode.py``: driving
``incremental_decode_step`` once per arriving frame gives, step for step,
the batch rollout's logits and actions, in the port and in
``videocad_tpu``, on the same weights (``state_dict_from_jax``) and the same
numpy-seeded frames; float32, a tiny config (hidden 64, image 32) with the
fused ViT attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.infer import incremental as jax_inc
from videocad_tpu.infer.rollout import prepare_for_decode as jax_prepare
from videocad_tpu.infer.rollout import sequential_inference as jax_rollout
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu_torch.infer.incremental import (incremental_decode_step,
                                                  init_decode_carry)
from videocad_tpu_torch.infer.rollout import (param_tree, prepare_for_decode,
                                              quantize_for_decode,
                                              sequential_inference)
from videocad_tpu_torch.models import create_model, state_dict_from_jax

CFG = dict(TINY_CONFIG, hidden_size=64, dim_feedforward=64,
           vit_attention_impl="fused")
B, T = 2, 6
OVERRIDES = {
    # the flagship's wiring: actions, states, timestep embedding
    "actions+states+ts": dict(enable_past_actions=True,
                              enable_past_states=True,
                              enable_timestep_embedding=True, window_size=3),
    # actions only: the frames never join the memory (a reference quirk)
    "actions-only": dict(enable_past_actions=True, enable_past_states=False,
                         enable_timestep_embedding=False, window_size=2),
}


def _pair(overrides, seed=0):
    cfg = dict(CFG, **overrides)
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(seed), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, params, model


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _drive(model, params, frames, cad):
    """incremental_decode_step over every frame -> stacked logits, carry."""
    carry = init_decode_carry(model, torch.from_numpy(cad), seq_len=T)
    cmds, pars = [], []
    for i in range(frames.shape[1]):
        carry, cmd, par = incremental_decode_step(
            model, params, torch.from_numpy(frames[:, i]), carry)
        cmds.append(cmd)
        pars.append(par)
    return torch.stack(cmds, 1), torch.stack(pars, 1), carry


def _assert_equal_rollouts(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5,
                                   rtol=0)
    for g, w in zip(got, want):   # the decoded actions, exactly
        np.testing.assert_array_equal(np.argmax(np.asarray(g), -1),
                                      np.argmax(np.asarray(w), -1))


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_incremental_equals_port_and_jax_rollouts(name):
    jax_model, params, model = _pair(OVERRIDES[name])
    frames = _uint8((B, T, 32, 32, 3), seed=1)
    cad = _uint8((B, 32, 32, 3), seed=2)
    cmd, par, carry = _drive(model, prepare_for_decode(model), frames, cad)
    assert int(carry["t"]) == T
    port = sequential_inference(model, torch.from_numpy(frames),
                                torch.from_numpy(cad))
    _assert_equal_rollouts((cmd, par), [x.numpy() for x in port])
    _assert_equal_rollouts((cmd, par), jax_rollout(
        jax_model, params, jnp.asarray(frames), jnp.asarray(cad)))
    # And JAX's own incremental step, step by step.
    jp = jax_prepare(params, jnp.float32)
    jcarry = jax_inc.init_decode_carry(jax_model, jp, jnp.asarray(cad), T)
    for i in range(T):
        jcarry, jcmd, jpar = jax_inc.incremental_decode_step(
            jax_model, jp, jnp.asarray(frames[:, i]), jcarry)
        _assert_equal_rollouts((cmd[:, i], par[:, i]), (jcmd, jpar))
    np.testing.assert_allclose(carry["action"].numpy(),
                               np.asarray(jcarry["action"]), atol=1e-6)


@pytest.mark.parametrize("mode,bits", [("int8", 8), ("int4", 4)])
def test_incremental_quantized_equals_quantized_rollout(mode, bits):
    """A decoder quantized once a session (quantize_for_decode) drives the
    step to the quantized batch rollout's logits: the memory K/V come from
    the quantized cross-attention key/value on both paths."""
    jax_model, params, model = _pair(OVERRIDES["actions+states+ts"], seed=3)
    frames = _uint8((B, T, 32, 32, 3), seed=4)
    cad = _uint8((B, 32, 32, 3), seed=5)
    got = _drive(model, quantize_for_decode(model, bits=bits), frames,
                 cad)[:2]
    _assert_equal_rollouts(got, [x.numpy() for x in sequential_inference(
        model, torch.from_numpy(frames), torch.from_numpy(cad),
        weight_quant=mode)])
    _assert_equal_rollouts(got, jax_rollout(
        jax_model, params, jnp.asarray(frames), jnp.asarray(cad),
        weight_quant=mode))


def test_incremental_prepared_fused_equals_raw_tree():
    """prepare_for_decode's tree (q/k/v fused, cast to the compute dtype)
    drives the step to the logits of the raw parameter tree, whose q, k, v
    stay apart, and to the batch rollout's."""
    _, _, model = _pair(OVERRIDES["actions+states+ts"], seed=6)
    frames = _uint8((B, T, 32, 32, 3), seed=7)
    cad = _uint8((B, 32, 32, 3), seed=8)
    fused = prepare_for_decode(model)
    raw = param_tree(model)
    assert "qkv" in fused["decoder"]["layers_0"]["self_attn"]
    assert "qkv" not in raw["decoder"]["layers_0"]["self_attn"]
    got = _drive(model, fused, frames, cad)[:2]
    for g, w in zip(got, _drive(model, raw, frames, cad)[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
    _assert_equal_rollouts(got, [x.numpy() for x in sequential_inference(
        model, torch.from_numpy(frames), torch.from_numpy(cad))])


def test_incremental_step_past_horizon_freezes_carry():
    """Past seq_len the carry is bit-frozen: t, action and every cache."""
    _, _, model = _pair(OVERRIDES["actions+states+ts"], seed=9)
    frames = _uint8((B, T + 2, 32, 32, 3), seed=10)
    cad = _uint8((B, 32, 32, 3), seed=11)
    params = prepare_for_decode(model)
    carry = init_decode_carry(model, torch.from_numpy(cad), seq_len=T)
    for i in range(T):
        carry, _, _ = incremental_decode_step(
            model, params, torch.from_numpy(frames[:, i]), carry)
    frozen = [carry["t"].clone(), carry["action"].clone()] + [
        x.clone() for kv in carry["self_kv"] + carry["mem_kv"] for x in kv]
    for i in range(T, T + 2):
        carry, _, _ = incremental_decode_step(
            model, params, torch.from_numpy(frames[:, i]), carry)
    after = [carry["t"], carry["action"]] + [
        x for kv in carry["self_kv"] + carry["mem_kv"] for x in kv]
    assert int(carry["t"]) == T
    for before, now in zip(frozen, after):
        assert torch.equal(before, now)


def test_incremental_rejects_no_action_feedback():
    _, _, model = _pair(dict(enable_past_actions=False), seed=12)
    with pytest.raises(ValueError, match="enable_past_actions"):
        init_decode_carry(model, torch.zeros((1, 32, 32, 3),
                                             dtype=torch.uint8), seq_len=4)
    carry = {"self_kv": [(torch.zeros(1, 4, 2, 32),) * 2]}
    with pytest.raises(ValueError, match="enable_past_actions"):
        incremental_decode_step(model, {}, torch.zeros(
            (1, 32, 32, 3), dtype=torch.uint8), carry)
