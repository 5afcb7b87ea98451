"""The PyTorch port's objective, optimizer and train / eval steps against
the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX
weights cross through ``state_dict_from_jax`` and gradients come back
through ``jax_tree_from_state_dict``. Parity is held at float32 with
dropout off (the two packages' generators differ); dropout is held by its
properties. The tiny config runs the ViT attention through the fused
kernel: the JAX side in Pallas interpret mode, the port through its plain
versions (CPU tensors), forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.data import synthetic as jax_synthetic
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.ops import losses as jax_losses
from videocad_tpu.train import metrics as jax_metrics
from videocad_tpu.train import objective as jax_objective
from videocad_tpu.train import state as jax_state
from videocad_tpu.train import steps as jax_steps
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.ops import losses as port_losses
from videocad_tpu_torch.ops.dropout import DropoutRng
from videocad_tpu_torch.train import metrics as port_metrics
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train import steps as port_steps

FUSED = dict(TINY_CONFIG, vit_attention_impl="fused")
JAX_LOSS = jax_objective.LossConfig(jax_objective.REFERENCE_CMD_WEIGHTS)
PORT_LOSS = port_objective.LossConfig(port_objective.REFERENCE_CMD_WEIGHTS)


def _logits_targets(rows, classes, seed, ignored=0.3, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((rows, classes))).astype(np.float32)
    targets = rng.integers(0, classes, rows)
    targets[rng.random(rows) < ignored] = -1
    return logits, targets


def _value_and_grad_jax(fn, logits):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    return float(value), np.asarray(grad)


def _value_and_grad_port(fn, logits):
    x = torch.from_numpy(logits).requires_grad_()
    value = fn(x)
    value.backward()
    return float(value), x.grad.numpy()


# ---- losses ----

@pytest.mark.parametrize("weighted,ignored", [(True, 0.3), (False, 0.3),
                                              (True, 1.0)])
def test_weighted_cross_entropy_matches_jax(weighted, ignored):
    logits, targets = _logits_targets(40, 5, seed=0, ignored=ignored)
    w = np.asarray(jax_objective.REFERENCE_CMD_WEIGHTS, np.float32)
    want, want_grad = _value_and_grad_jax(
        lambda x: jax_losses.weighted_cross_entropy(
            x, jnp.asarray(targets), jnp.asarray(w) if weighted else None),
        logits)
    got, got_grad = _value_and_grad_port(
        lambda x: port_losses.weighted_cross_entropy(
            x, torch.from_numpy(targets),
            torch.from_numpy(w) if weighted else None), logits)
    if ignored == 1.0:
        assert got == want == 0.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-6, rtol=0)


@pytest.mark.parametrize("above,ignore_valid,ignored", [
    (True, True, 0.3), (True, False, 0.3), (False, True, 0.3),
    (False, False, 0.3), (True, True, 1.0)])
def test_flexible_cross_entropy_matches_jax(above, ignore_valid, ignored):
    # Peaked logits, so that some argmax predictions fall inside the window
    # and ignore_valid has rows to drop.
    logits, targets = _logits_targets(48, 60, seed=1, ignored=ignored)
    hit = np.arange(0, 48, 3)
    logits[hit, np.clip(targets[hit], 0, 59)] += 30.0
    kw = dict(tolerance=4, above=above, ignore_valid=ignore_valid)
    want, want_grad = _value_and_grad_jax(
        lambda x: jax_losses.flexible_cross_entropy(
            x, jnp.asarray(targets), **kw), logits)
    got, got_grad = _value_and_grad_port(
        lambda x: port_losses.flexible_cross_entropy(
            x, torch.from_numpy(targets), **kw), logits)
    if ignored == 1.0:
        assert got == want == 0.0
    else:
        assert want > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-6, rtol=0)


@pytest.mark.parametrize("above", [True, False])
def test_tolerance_interval_matches_jax(above):
    targets = np.asarray([0, 1, 5, 500, 997, 998, 999])
    want = jax_losses.tolerance_interval(jnp.asarray(targets), 3, above, 1000)
    got = port_losses.tolerance_interval(torch.from_numpy(targets), 3, above,
                                         1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- objective ----

def _objective_inputs(seed, b=3, t=34):
    rng = np.random.default_rng(seed)
    cmd_logits = rng.standard_normal((b, t, 5)).astype(np.float32)
    param_logits = rng.standard_normal((b, t, 6, 1000)).astype(np.float32)
    targets = np.stack([port_synthetic.random_action_sequence(rng, t)
                        for _ in range(b)]).astype(np.float32)
    targets[0, -4:] = -1                       # a padded tail
    # Make a share of the predictions right, so the "correct" counters and
    # the in-window rows are exercised.
    for bi in range(b):
        for ti in range(0, t, 2):
            cmd = int(targets[bi, ti, 0])
            if cmd >= 0:
                cmd_logits[bi, ti, cmd] += 20.0
            for p in range(6):
                val = int(targets[bi, ti, 1 + p])
                if val >= 0:
                    param_logits[bi, ti, p, min(val + (ti % 3), 999)] += 20.0
    return cmd_logits, param_logits, targets


def _bin_weights():
    rng = np.random.default_rng(5)
    data = {"Label": list(jax_objective.REFERENCE_CMD_WEIGHTS)}
    for name in ("x", "Key Pressed"):
        data[name] = [float(v) for v in rng.random(1000) + 0.5]
    return data


@pytest.mark.parametrize("use_mse,above_quirk", [(True, True), (True, False),
                                                 (False, True)])
def test_compute_loss_and_metrics_matches_jax(use_mse, above_quirk):
    cmd_logits, param_logits, targets = _objective_inputs(seed=2)
    kw = dict(use_mse=use_mse, above_quirk=above_quirk)
    jax_cfg = jax_objective.LossConfig.from_class_weights(_bin_weights(), **kw)
    port_cfg = port_objective.LossConfig.from_class_weights(_bin_weights(),
                                                            **kw)
    want_loss, want = jax_objective.compute_loss_and_metrics(
        jnp.asarray(cmd_logits), jnp.asarray(param_logits),
        jnp.asarray(targets), jax_cfg)
    got_loss, got = port_objective.compute_loss_and_metrics(
        torch.from_numpy(cmd_logits), torch.from_numpy(param_logits),
        torch.from_numpy(targets), port_cfg)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=1e-5,
                               rtol=0)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].dim() == 0
        assert float(got[key]) == float(want[key]), key
    assert float(got["correct_predictions"]) > 0
    assert float(got["param_correct_topk"]) > 0


def test_loss_config_from_class_weights_matches_jax():
    data = _bin_weights()
    for use_mse in (True, False):
        want = jax_objective.LossConfig.from_class_weights(data, use_mse)
        got = port_objective.LossConfig.from_class_weights(data, use_mse)
        assert got.cmd_weights == want.cmd_weights
        assert got.param_bin_weights == want.param_bin_weights
        assert (got.use_mse, got.above_quirk) == (want.use_mse,
                                                  want.above_quirk)
    assert got.param_bin_weights[1] is None       # "y" has no entry
    assert len(got.param_bin_weights[0]) == 1000
    with pytest.raises(ValueError, match="Label"):
        port_objective.LossConfig.from_class_weights({"Label": 3})
    assert (port_objective.REFERENCE_CMD_WEIGHTS
            == jax_objective.REFERENCE_CMD_WEIGHTS)
    assert port_objective.TOPK == jax_objective.TOPK


def test_update_metrics_matches_jax():
    cmd_logits, param_logits, targets = _objective_inputs(seed=3)
    _, counters = port_objective.compute_loss_and_metrics(
        torch.from_numpy(cmd_logits), torch.from_numpy(param_logits),
        torch.from_numpy(targets), PORT_LOSS)
    as_floats = {k: float(v) for k, v in counters.items()}
    want = jax_metrics.update_metrics(jax_metrics.init_metrics(), as_floats)
    got = port_metrics.update_metrics(port_metrics.init_metrics(), counters)
    got = port_metrics.update_metrics(got, {})      # a no-op batch
    assert got == want
    assert 0 < got["cmd_accuracy"] <= 100


# ---- data and step inputs ----

def test_synthetic_batch_feed_equals_jax():
    want = jax_synthetic.synthetic_batch_feed(2, 7, image_size=16, seed=4)
    got = port_synthetic.synthetic_batch_feed(2, 7, image_size=16, seed=4)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    seq = port_synthetic.random_action_sequence(np.random.default_rng(0), 9)
    np.testing.assert_array_equal(
        seq, jax_synthetic.random_action_sequence(np.random.default_rng(0), 9))
    assert seq[-1, 3] == 950 and (seq[0] == 0).all()


def _batch(b=2, t=8, seed=0):
    data = port_synthetic.synthetic_batch_feed(b, t, image_size=32, seed=seed)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def test_prepare_model_inputs_equals_jax():
    jax_batch, port_batch = _batch()
    want_inputs, want_targets = jax_steps.prepare_model_inputs(jax_batch)
    got_inputs, got_targets = port_steps.prepare_model_inputs(port_batch)
    assert sorted(got_inputs) == sorted(want_inputs)
    for key in want_inputs:
        np.testing.assert_array_equal(got_inputs[key].numpy(),
                                      np.asarray(want_inputs[key]))
    np.testing.assert_array_equal(got_targets.numpy(),
                                  np.asarray(want_targets))
    assert got_inputs["frames"].shape[1] == 7


def test_add_action_noise_touches_only_valid_slots():
    rng = np.random.default_rng(6)
    actions = np.stack([port_synthetic.random_action_sequence(rng, 200)
                        for _ in range(4)]).astype(np.float32)
    actions[0, 1] = [0, 0, 999, -1, -1, -1, -1]      # boundary values
    noisy = port_steps.add_action_noise(
        torch.from_numpy(actions), torch.Generator().manual_seed(0)).numpy()
    delta = noisy - actions
    move, typed = actions[..., 0] == 0, actions[..., 0] == 3
    assert np.all(delta[..., [0, 3, 4, 5]] == 0)
    assert np.all(delta[..., 1:3][~move] == 0)
    assert np.all(delta[..., 6][~typed] == 0)
    assert set(np.unique(delta[..., 1:3][move])) == {-2, -1, 0, 1, 2}
    assert set(np.unique(delta[..., 6][typed])) == {-2, -1, 0, 1, 2}
    # Unclamped on purpose: values may leave [0, 999].
    again = port_steps.add_action_noise(
        torch.from_numpy(actions), torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(noisy, again)
    others = [port_steps.add_action_noise(
        torch.from_numpy(actions), torch.Generator().manual_seed(s)).numpy()
        for s in range(1, 30)]
    assert any(o[0, 1, 1] < 0 or o[0, 1, 2] > 999 for o in others)


# ---- train and eval steps ----

def _pair(overrides=None, training_config=None, freeze_cad=False, seed=0):
    cfg = dict(FUSED, **(overrides or {}))
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(seed), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    tc = training_config or {"lr": 1e-3}
    jax_st, jax_tx = jax_state.create_train_state(params, tc, freeze_cad)
    port_st = port_state.create_train_state(
        dict(model.named_parameters()), tc, freeze_cad)
    return jax_model, jax_st, jax_tx, model, port_st


def _is_key_bias(path) -> bool:
    """An attention key bias: its gradient is zero in exact arithmetic (a
    shift of every score of a row leaves the softmax unchanged), so both
    packages hold only rounding noise there, and Adam, which divides by
    the gradient's magnitude, turns that noise into steps of up to lr."""
    names = [getattr(p, "key", None) for p in path]
    return names[-2:] == ["key", "bias"]


def _assert_trees_close(got_tree, want_tree, tol, relative,
                        key_bias_tol=None):
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert sorted(map(str, got)) == sorted(map(str, want))
    assert any(_is_key_bias(path) for path in want)
    for path, w in want.items():
        w = np.asarray(w)
        if key_bias_tol is not None and _is_key_bias(path):
            np.testing.assert_allclose(np.asarray(got[path]), w, rtol=0,
                                       atol=key_bias_tol, err_msg=str(path))
            continue
        scale = max(np.abs(w).max(), 1e-30) if relative else 1.0
        np.testing.assert_allclose(np.asarray(got[path]) / scale, w / scale,
                                   atol=tol, rtol=0, err_msg=str(path))


def test_loss_and_gradients_match_jax():
    jax_model, jax_st, _, model, _ = _pair()
    jax_batch, port_batch = _batch(seed=1)

    def loss_fn(params):
        inputs, targets = jax_steps.prepare_model_inputs(jax_batch)
        preds = jax_model.apply({"params": params}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax_st.params)
    inputs, targets = port_steps.prepare_model_inputs(port_batch)
    loss = port_objective.compute_loss_and_metrics(*model(inputs), targets,
                                                   PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())
    # 1e-4 of each tensor's largest entry; the key biases' noise gradients
    # are held to an absolute 1e-6 instead.
    _assert_trees_close(jax_tree_from_state_dict(grads), want_grads, 1e-4,
                        relative=True, key_bias_tol=1e-6)
    # The case exercises the clip: the gradient's global norm is above 1.
    assert float(optax.global_norm(want_grads)) > 1.0


@pytest.mark.parametrize("steps", [1, 3])
def test_parameters_after_train_steps_match_jax(steps):
    jax_model, jax_st, jax_tx, model, port_st = _pair()
    jax_batch, port_batch = _batch(seed=1)
    jax_step = jax.jit(jax_steps.make_train_step(jax_model, jax_tx, JAX_LOSS))
    port_step = port_steps.make_train_step(model, PORT_LOSS)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(steps):
        jax_st, want_loss, want_metrics = jax_step(jax_st, jax_batch,
                                                   jax.random.PRNGKey(0))
        port_st, loss, metrics = port_step(port_st, port_batch, 0)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert port_st.step == steps == int(jax_st.step)
    assert not model.training and not loss.requires_grad
    for key in want_metrics:
        assert float(metrics[key]) == float(want_metrics[key]), key
    after = model.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in before
               if "norm" not in k or "weight" not in k)
    assert port_st.params["predict_cmd.weight"] is model.predict_cmd.weight
    # lr 1e-3: a key bias may differ by up to lr in either package a step.
    _assert_trees_close(jax_tree_from_state_dict(after), jax_st.params, 1e-5,
                        relative=False, key_bias_tol=2e-3 * steps)


@pytest.mark.parametrize("scale", [0.01, 30.0])
def test_clip_by_global_norm_is_the_optax_rule(scale):
    rng = np.random.default_rng(7)
    arrays = [scale * rng.standard_normal(s).astype(np.float32)
              for s in [(4, 5), (7,), (2, 3, 2)]]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in arrays], optax.EmptyState())
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    norm = port_state.clip_by_global_norm_(grads)
    np.testing.assert_allclose(
        float(norm), float(optax.global_norm([jnp.asarray(a) for a in arrays])),
        rtol=1e-6)
    assert (float(norm) > 1.0) == (scale > 1.0)
    for g, w, a in zip(grads, want, arrays):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), a)


def test_freeze_cad_leaves_the_cad_encoder_unchanged():
    jax_model, jax_st, jax_tx, model, port_st = _pair(
        freeze_cad=True)
    jax_batch, port_batch = _batch(seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jax_st, _, _ = jax.jit(jax_steps.make_train_step(
        jax_model, jax_tx, JAX_LOSS))(jax_st, jax_batch,
                                      jax.random.PRNGKey(0))
    port_steps.make_train_step(model, PORT_LOSS)(port_st, port_batch,
                                                          0)
    after = model.state_dict()
    cad = [k for k in before if k.startswith("cad_encoder.")]
    assert cad and all(torch.equal(after[k], before[k]) for k in cad)
    assert not torch.equal(after["state_encoder.block_0.attn.query.weight"],
                           before["state_encoder.block_0.attn.query.weight"])
    # The clip still sees the CAD encoder's gradients, as optax's chain does.
    _assert_trees_close(jax_tree_from_state_dict(after), jax_st.params, 1e-5,
                        relative=False, key_bias_tol=2e-3)


def test_frozen_uses_the_component_learning_rates():
    tc = {"lr": 1e-3, "frozen": True, "lr_cad": 1e-4, "lr_state": 5e-4}
    jax_model, jax_st, jax_tx, model, port_st = _pair(
        training_config=tc)
    groups = {round(g["lr"], 7): len(g["params"])
              for g in port_st.opt_state.param_groups}
    assert sorted(groups) == [1e-4, 5e-4, 1e-3]
    n_vit = sum(1 for k in port_st.params if k.startswith("cad_encoder."))
    assert groups[1e-4] == groups[5e-4] == n_vit
    jax_batch, port_batch = _batch(seed=3)
    jax_st, _, _ = jax.jit(jax_steps.make_train_step(
        jax_model, jax_tx, JAX_LOSS))(jax_st, jax_batch,
                                      jax.random.PRNGKey(0))
    port_steps.make_train_step(model, PORT_LOSS)(port_st, port_batch,
                                                          0)
    # 2e-5, 2% of the largest learning rate: Adam's first step moves an
    # element by lr * g / (|g| + eps), so an element whose gradient is
    # within a few hundred ulps of rounding noise lands that share of lr
    # apart in the two packages.
    _assert_trees_close(jax_tree_from_state_dict(model.state_dict()),
                        jax_st.params, 2e-5, relative=False,
                        key_bias_tol=2e-3)


@pytest.mark.parametrize("ablate_cad", [False, True])
def test_eval_step_matches_jax(ablate_cad):
    jax_model, jax_st, _, model, _ = _pair(seed=4)
    jax_batch, port_batch = _batch(seed=4)
    want_loss, want = jax_steps.make_eval_step(
        jax_model, JAX_LOSS, ablate_cad)(jax_st.params, jax_batch)
    model.train()
    loss, got = port_steps.make_eval_step(model, PORT_LOSS, ablate_cad)(
        port_batch)
    assert model.training and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for key in want:
        assert float(got[key]) == float(want[key]), key


def test_ablating_the_cad_image_changes_the_eval_loss():
    _, _, _, model, _ = _pair(seed=4)
    _, port_batch = _batch(seed=4)
    plain = port_steps.make_eval_step(model, PORT_LOSS)(port_batch)[0]
    ablated = port_steps.make_eval_step(model, PORT_LOSS, True)(port_batch)[0]
    assert float(plain) != float(ablated)


# ---- dropout in the train step ----

def _dropout_model():
    model = create_model(dict(FUSED, dropout=0.1))
    state = port_state.create_train_state(dict(model.named_parameters()),
                                          {"lr": 1e-3})
    return model, state, port_steps.make_train_step(model, PORT_LOSS,
                                                    noise=True)


def test_train_step_with_dropout_repeats_for_a_seed_and_differs_across():
    _, port_batch = _batch(seed=5)
    losses = {}
    for run, seed in [("a", 11), ("b", 11), ("c", 12)]:
        model, state, step = _dropout_model()
        state, first, _ = step(state, port_batch, seed)
        state, second, _ = step(state, port_batch, seed)
        losses[run] = (float(first), float(second))
        assert np.isfinite(losses[run]).all()
        # The step number is folded in: the second step draws other masks.
        assert losses[run][0] != losses[run][1]
    assert losses["a"] == losses["b"]
    assert losses["a"][0] != losses["c"][0]


def test_dropout_is_off_in_eval_mode_and_needs_rng_in_train_mode():
    model = create_model(dict(FUSED, dropout=0.1))
    reference = create_model(FUSED)                 # dropout 0.0
    reference.load_state_dict(model.state_dict())
    _, port_batch = _batch(seed=6)
    inputs, _ = port_steps.prepare_model_inputs(port_batch)
    with torch.no_grad():
        want = reference(inputs)
        got = model(inputs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        model.train()
        with pytest.raises(ValueError, match="needs rng"):
            model(inputs)
        dropped = model(inputs, rng=DropoutRng(0))
        again = model(inputs, rng=DropoutRng(0))
        other = model(inputs, rng=DropoutRng(1))
    assert not torch.equal(dropped[1], want[1])
    torch.testing.assert_close(dropped[1], again[1], rtol=0, atol=0)
    assert not torch.equal(dropped[1], other[1])


def test_every_parameter_gets_a_finite_gradient_with_dropout():
    model, state, step = _dropout_model()
    _, port_batch = _batch(seed=7)
    step(state, port_batch, 3)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    assert grads["state_encoder.block_0.attn.query.weight"].abs().max() > 0


# ---- the train step under ln_impl / dropout_impl "pallas" ----

PALLAS = {"ln_impl": "pallas", "dropout_impl": "pallas"}


def test_loss_and_gradients_match_jax_under_ln_impl_pallas():
    jax_model, jax_st, _, model, _ = _pair(PALLAS)
    jax_batch, port_batch = _batch(seed=1)

    def loss_fn(params):
        inputs, targets = jax_steps.prepare_model_inputs(jax_batch)
        preds = jax_model.apply({"params": params}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax_st.params)
    inputs, targets = port_steps.prepare_model_inputs(port_batch)
    loss = port_objective.compute_loss_and_metrics(*model(inputs), targets,
                                                   PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    grads = {name: p.grad for name, p in model.named_parameters()}
    _assert_trees_close(jax_tree_from_state_dict(grads), want_grads, 1e-4,
                        relative=True, key_bias_tol=1e-6)


def test_parameters_after_train_steps_match_jax_under_ln_impl_pallas():
    steps = 3
    jax_model, jax_st, jax_tx, model, port_st = _pair(PALLAS)
    jax_batch, port_batch = _batch(seed=1)
    jax_step = jax.jit(jax_steps.make_train_step(jax_model, jax_tx, JAX_LOSS))
    port_step = port_steps.make_train_step(model, PORT_LOSS)
    for _ in range(steps):
        jax_st, want_loss, want_metrics = jax_step(jax_st, jax_batch,
                                                   jax.random.PRNGKey(0))
        port_st, loss, metrics = port_step(port_st, port_batch, 0)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for key in want_metrics:
        assert float(metrics[key]) == float(want_metrics[key]), key
    _assert_trees_close(jax_tree_from_state_dict(model.state_dict()),
                        jax_st.params, 1e-5, relative=False,
                        key_bias_tol=2e-3 * steps)


def test_train_step_with_pallas_dropout_repeats_for_a_seed_and_differs():
    _, port_batch = _batch(seed=5)
    losses = {}
    for run, seed in [("a", 11), ("b", 11), ("c", 12)]:
        model = create_model(dict(FUSED, dropout=0.1, **PALLAS))
        state = port_state.create_train_state(
            dict(model.named_parameters()), {"lr": 1e-3})
        step = port_steps.make_train_step(model, PORT_LOSS)
        state, first, _ = step(state, port_batch, seed)
        state, second, _ = step(state, port_batch, seed)
        losses[run] = (float(first), float(second))
        assert np.isfinite(losses[run]).all()
        assert losses[run][0] != losses[run][1]
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert losses["a"] == losses["b"]
    assert losses["a"][0] != losses["c"][0]


# ---- the train step under attention_impl, ln_impl and dropout_impl
# "pallas" ----

ALL_PALLAS = dict(PALLAS, attention_impl="pallas")


def test_loss_and_gradients_match_jax_under_all_three_pallas_settings():
    """One train step's loss and gradients with the decoder's attention
    through flash attention as well: the JAX side differentiates through
    its interpreted Pallas forward, dQ and dK/dV kernels, the port through
    its plain backward (the kernels' formulas). A short batch keeps the JAX
    side's interpreted kernels quick. Loss 1e-4 relative, gradients 1e-4 of
    each tensor's largest entry, key biases an absolute 1e-6."""
    jax_model, jax_st, _, model, _ = _pair(ALL_PALLAS)
    jax_batch, port_batch = _batch(b=2, t=6, seed=2)

    def loss_fn(params):
        inputs, targets = jax_steps.prepare_model_inputs(jax_batch)
        preds = jax_model.apply({"params": params}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax_st.params)
    inputs, targets = port_steps.prepare_model_inputs(port_batch)
    loss = port_objective.compute_loss_and_metrics(*model(inputs), targets,
                                                   PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    grads = {name: p.grad for name, p in model.named_parameters()}
    _assert_trees_close(jax_tree_from_state_dict(grads), want_grads, 1e-4,
                        relative=True, key_bias_tol=1e-6)


def test_train_step_under_all_three_pallas_settings_matches_the_plain_step():
    """The port's train step under the three "pallas" settings against its
    own step under "xla" from the same weights: the loss within 1e-5, the
    parameters after the step within 1e-5."""
    _, _, _, model, port_st = _pair(ALL_PALLAS)
    _, _, _, plain, plain_st = _pair()
    plain.load_state_dict(model.state_dict())
    _, port_batch = _batch(seed=3)
    _, loss, metrics = port_steps.make_train_step(model, PORT_LOSS)(
        port_st, port_batch, 0)
    _, want_loss, want_metrics = port_steps.make_train_step(
        plain, PORT_LOSS)(plain_st, port_batch, 0)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for key in want_metrics:
        assert float(metrics[key]) == float(want_metrics[key]), key
    want = plain.state_dict()
    for name, value in model.state_dict().items():
        if name.endswith(".key.bias"):
            continue     # noise gradients, which Adam turns into steps of lr
        assert (value - want[name]).abs().max().item() <= 1e-5, name


def test_train_step_with_flash_attention_dropout_repeats_for_a_seed():
    _, port_batch = _batch(seed=5)
    losses = {}
    for run, seed in [("a", 11), ("b", 11), ("c", 12)]:
        model = create_model(dict(FUSED, dropout=0.1, **ALL_PALLAS))
        state = port_state.create_train_state(
            dict(model.named_parameters()), {"lr": 1e-3})
        step = port_steps.make_train_step(model, PORT_LOSS)
        state, first, _ = step(state, port_batch, seed)
        losses[run] = float(first)
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert losses["a"] == losses["b"] != losses["c"]


# ---- the train step under vit_attention_impl / vit_mlp_impl "block" ----

BLOCK_SETTINGS = {
    "block": {"vit_attention_impl": "block", "vit_depth": 2},
    "fused_attention_block_mlp": {"vit_attention_impl": "fused",
                                  "vit_mlp_impl": "block", "vit_depth": 2},
}


@pytest.mark.parametrize("setting", sorted(BLOCK_SETTINGS))
def test_loss_and_gradients_match_jax_under_block(setting):
    """One train step's loss and gradients with the ViT through the fused
    sub-block kernels (depth 2): the JAX side differentiates through its
    interpreted Pallas forward and backward kernels, the port through its
    written-out plain backward. Loss 1e-4 relative, gradients 1e-4 of each
    tensor's largest entry, key biases an absolute 1e-6."""
    jax_model, jax_st, _, model, _ = _pair(BLOCK_SETTINGS[setting])
    jax_batch, port_batch = _batch(b=2, t=6, seed=4)

    def loss_fn(params):
        inputs, targets = jax_steps.prepare_model_inputs(jax_batch)
        preds = jax_model.apply({"params": params}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax_st.params)
    inputs, targets = port_steps.prepare_model_inputs(port_batch)
    loss = port_objective.compute_loss_and_metrics(*model(inputs), targets,
                                                   PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())
    _assert_trees_close(jax_tree_from_state_dict(grads), want_grads, 1e-4,
                        relative=True, key_bias_tol=1e-6)


@pytest.mark.parametrize("setting", sorted(BLOCK_SETTINGS))
def test_train_step_under_block_matches_the_unfused_step(setting):
    """The port's train step under "block" against its own step under
    "fused" from the same weights: the loss within 1e-5, the metrics equal,
    the gradients the step left within 1e-5 of each tensor's largest entry
    (the parameters themselves are not compared: Adam turns the rounding
    noise of a near-zero gradient into a step of lr)."""
    overrides = BLOCK_SETTINGS[setting]
    _, _, _, model, port_st = _pair(overrides)
    _, _, _, plain, plain_st = _pair({"vit_depth": 2})
    plain.load_state_dict(model.state_dict())
    _, port_batch = _batch(seed=3)
    _, loss, metrics = port_steps.make_train_step(model, PORT_LOSS)(
        port_st, port_batch, 0)
    _, want_loss, want_metrics = port_steps.make_train_step(
        plain, PORT_LOSS)(plain_st, port_batch, 0)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for key in want_metrics:
        assert float(metrics[key]) == float(want_metrics[key]), key
    want = dict(plain.named_parameters())
    for name, param in model.named_parameters():
        if name.endswith(".key.bias"):
            continue     # zero in exact arithmetic: rounding noise
        scale = want[name].grad.abs().max().item()
        err = (param.grad - want[name].grad).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)


def test_train_step_with_block_dropout_repeats_for_a_seed_and_differs():
    _, port_batch = _batch(seed=5)
    losses = {}
    for run, seed in [("a", 11), ("b", 11), ("c", 12)]:
        model = create_model(dict(FUSED, dropout=0.1, dropout_impl="pallas",
                                  **BLOCK_SETTINGS["block"]))
        state = port_state.create_train_state(
            dict(model.named_parameters()), {"lr": 1e-3})
        step = port_steps.make_train_step(model, PORT_LOSS)
        state, first, _ = step(state, port_batch, seed)
        losses[run] = float(first)
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert losses["a"] == losses["b"] != losses["c"]
