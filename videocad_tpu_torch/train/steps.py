"""Train and eval steps.

Port of ``videocad_tpu/train/steps.py``: teacher-forcing shift, optional
action-noise augmentation, forward in ``train()`` mode, class-weighted
tolerance loss, backward, global-norm clip, Adam update. PyTorch runs them
eagerly, so ``jit_train_step`` has no counterpart, and neither has
``dropout_rng_impl`` (a choice between JAX generator implementations): the
step's randomness comes from ``torch.Generator``s made from (seed, step).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from videocad_tpu_torch.actions.ops import normalize_actions
from videocad_tpu_torch.actions.vocab import CMD_MOVE_TO, CMD_TYPE
from videocad_tpu_torch.ops.dropout import DropoutRng
from videocad_tpu_torch.ops.prng import fold_in
from videocad_tpu_torch.train.objective import (LossConfig,
                                                compute_loss_and_metrics)
from videocad_tpu_torch.train.state import TrainState


def add_action_noise(actions: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """A jitter of up to 2 bins either way on move-to x/y and typed value.

    Applied to the raw batch actions, so both the teacher-forced inputs and
    the targets see the noise, matching the reference. ``generator`` lives
    on the actions' device.
    """
    # Deliberately UNCLAMPED, like the reference: a boundary value can
    # jitter to -1 (the pad sentinel: that step silently drops from the
    # loss) or past the top bin (999 + 2 = 1001, outside the vocab). Both
    # are rare edges the reference trains through; clamping would change
    # gradients against it.
    def jitter(shape):
        return torch.randint(-2, 3, shape, generator=generator,
                             device=actions.device).to(actions.dtype)

    cmd = actions[..., 0:1]
    xy = actions[..., 1:3] + jitter(actions[..., 1:3].shape) * (
        cmd == CMD_MOVE_TO).to(actions.dtype)
    typed = actions[..., 6:7] + jitter(actions[..., 6:7].shape) * (
        cmd == CMD_TYPE).to(actions.dtype)
    return torch.cat([cmd, xy, actions[..., 3:6], typed], dim=-1)


def prepare_model_inputs(batch: Dict[str, torch.Tensor]
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Teacher-forcing shift: inputs drop the last step, targets the first
    (normalize-then-shift order, as the reference)."""
    model_inputs = {
        "frames": batch["frames"][:, :-1],
        "actions": normalize_actions(batch["actions"])[:, :-1],
        "cad_image": batch["cad_image"],
    }
    if batch.get("multiview_images") is not None:
        model_inputs["multiview_images"] = batch["multiview_images"]
    return model_inputs, batch["actions"][:, 1:]


def make_train_step(model, loss_config: LossConfig, noise: bool = False):
    """Returns train_step(state, batch, seed) -> (state, loss, metrics).

    ``batch`` holds tensors on the model's device; ``seed`` is an int, and
    the step's generators (action noise, dropout) are made from (seed,
    ``state.step``), so every step draws fresh masks and a run repeats
    exactly. The model's parameters (``state.params``) are updated in
    place; the loss and the metric counters stay on the device.
    """

    def train_step(state: TrainState, batch, seed: int):
        step_seed = fold_in(seed, state.step)
        device = model.device
        if noise:
            noise_gen = torch.Generator(device=device).manual_seed(
                fold_in(step_seed, 0))
            batch = dict(batch, actions=add_action_noise(batch["actions"],
                                                         noise_gen))
        rng = DropoutRng(fold_in(step_seed, 1), device)
        model_inputs, targets = prepare_model_inputs(batch)
        was_training = model.training
        model.train()
        try:
            cmd_logits, param_logits = model(model_inputs, rng=rng)
        finally:
            model.train(was_training)
        loss, metrics = compute_loss_and_metrics(cmd_logits, param_logits,
                                                 targets, loss_config)
        model.zero_grad(set_to_none=True)
        loss.backward()
        return state.apply_gradients(), loss.detach(), metrics

    return train_step


def make_eval_step(model, loss_config: LossConfig, ablate_cad: bool = False):
    """Returns eval_step(batch) -> (loss, metrics): the teacher-forced
    evaluation of the model's current parameters, dropout off."""

    @torch.no_grad()
    def eval_step(batch):
        model_inputs, targets = prepare_model_inputs(batch)
        if ablate_cad:
            model_inputs["cad_image"] = torch.zeros_like(
                model_inputs["cad_image"])
        was_training = model.training
        model.eval()
        try:
            cmd_logits, param_logits = model(model_inputs)
        finally:
            model.train(was_training)
        return compute_loss_and_metrics(cmd_logits, param_logits, targets,
                                        loss_config)

    return eval_step
