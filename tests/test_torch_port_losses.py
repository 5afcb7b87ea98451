"""Parameter targets outside the 1,000 bins under ``use_mse: false``.

A move-to's x can leave the bins (``etl/handlers.py``: the reference's +15
on x). JAX's ``take_along_axis`` gives NaN for such a target, with bin
weights or without, and the objective's NaN guard zeroes that parameter's
loss for the batch. The port must do the same, on the CPU without an
out-of-bounds error and on the card without a device-side assert. Both
packages run the same numpy inputs; float32, 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocad_tpu.ops import losses as jax_losses
from videocad_tpu.train import objective as jax_objective
from videocad_tpu_torch.ops import losses as port_losses
from videocad_tpu_torch.train import objective as port_objective

TARGETS = [
    [3, 1005, -1, 999],       # past the last bin: NaN
    [3, 998, -1, 999],        # in range
    [3, -2, -1, 999],         # negative: counts from the end, as in JAX
    [3, -1000, -1, 999],
    [3, -1001, -1, 999],      # below -C: NaN
    [1000, 1000, -1, -1],
]


def _bins():
    return (np.random.default_rng(4).random(1000) * 2 + 0.1).astype(
        np.float32)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("targets", TARGETS, ids=[str(t) for t in TARGETS])
def test_weighted_cross_entropy_gives_nan_where_jax_does(targets, weighted):
    logits = np.random.default_rng(0).standard_normal((4, 1000)).astype(
        np.float32)
    w = _bins() if weighted else None
    want = float(jax_losses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        None if w is None else jnp.asarray(w)))
    x = torch.from_numpy(logits).requires_grad_()
    got = port_losses.weighted_cross_entropy(
        x, torch.tensor(targets), None if w is None else torch.from_numpy(w))
    assert np.isnan(float(got)) == np.isnan(want)
    if not np.isnan(want):
        np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=0)
    # The guard's where gives a finite (zero) gradient either way.
    torch.where(torch.isnan(got), 0.0, got).backward()
    assert bool(torch.isfinite(x.grad).all())


def _inputs(seed=2, b=2, t=12):
    rng = np.random.default_rng(seed)
    cmd_logits = rng.standard_normal((b, t, 5)).astype(np.float32)
    param_logits = rng.standard_normal((b, t, 6, 1000)).astype(np.float32)
    targets = np.concatenate(
        [rng.integers(0, 5, (b, t, 1)), rng.integers(-1, 1000, (b, t, 6))],
        axis=-1).astype(np.float32)
    targets[0, 3, 1] = 1005          # a move-to x past the bins
    targets[1, 5, 2] = 1001
    return cmd_logits, param_logits, targets


@pytest.mark.parametrize("weighted", [True, False])
def test_objective_zeroes_an_out_of_range_parameter_loss_as_jax(weighted):
    cmd_logits, param_logits, targets = _inputs()
    data = {"Label": list(jax_objective.REFERENCE_CMD_WEIGHTS)}
    if weighted:
        data.update({"x": _bins().tolist(), "y": _bins().tolist()})
    jax_cfg = jax_objective.LossConfig.from_class_weights(data,
                                                          use_mse=False)
    port_cfg = port_objective.LossConfig.from_class_weights(data,
                                                            use_mse=False)

    def jax_loss(p):
        return jax_objective.compute_loss_and_metrics(
            jnp.asarray(cmd_logits), p, jnp.asarray(targets), jax_cfg)

    (want_loss, want), want_grad = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(param_logits))
    x = torch.from_numpy(param_logits).requires_grad_()
    got_loss, got = port_objective.compute_loss_and_metrics(
        torch.from_numpy(cmd_logits), x, torch.from_numpy(targets), port_cfg)
    got_loss.backward()
    assert np.isfinite(float(want_loss)) and np.isfinite(float(got_loss))
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=1e-6,
                               rtol=0)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   atol=1e-6, rtol=0, err_msg=key)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=1e-6, rtol=0)
    # x and y lost their loss: no gradient reaches their logits.
    assert not x.grad[..., :2, :].any()
    assert x.grad[..., 2:, :].abs().sum() > 0
