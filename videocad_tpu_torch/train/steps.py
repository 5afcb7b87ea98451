"""Train and eval steps.

Port of ``videocad_tpu/train/steps.py``: teacher-forcing shift, optional
action-noise augmentation, forward in ``train()`` mode, class-weighted
tolerance loss, backward, global-norm clip, Adam update. PyTorch runs them
eagerly, so ``jit_train_step`` has no counterpart, and neither has
``dropout_rng_impl`` (a choice between JAX generator implementations): the
step's randomness comes from ``torch.Generator``s made from (seed, step).

With a mesh (``parallel/mesh.py``) the model is split over its model axis
(``parallel/sharding.py:shard_model``, done by the caller) and the step
runs under ``DistributedDataParallel`` over its data group: the objective
divides by global denominators and DDP sums the gradients (a summing comm
hook). DDP is built with ``static_graph=True``: ``remat_encoder``
recomputes the encoder's blocks inside the backward, and the static graph
lets DDP take their gradients as they come without searching the graph for
unused parameters every step (there are none: GenCAD's frozen encoder
still gets gradients, which the clip counts, as in JAX). Dropout folds the
data rank into the step's seed, so data ranks draw other masks, and sites
on activations split over the model axis draw from a stream of their own
a model rank (``ops/dropout.py:DropoutRng.sharded``). The action noise is
a counter-based function of (seed, row of the global batch, step, slot),
so a data rank draws the noise of its rows in one process's batch, whatever
length its rows are padded to.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn.parallel import DistributedDataParallel

from videocad_tpu_torch.actions.ops import normalize_actions
from videocad_tpu_torch.actions.vocab import CMD_MOVE_TO, CMD_TYPE
from videocad_tpu_torch.ops.dropout import DropoutRng
from videocad_tpu_torch.ops.prng import NOISE_KEY_WORD, dropout_bits, fold_in
from videocad_tpu_torch.parallel.collectives import sum_gradients_hook
from videocad_tpu_torch.train.objective import (LossConfig,
                                                compute_loss_and_metrics)
from videocad_tpu_torch.train.state import TrainState
from videocad_tpu_torch.utils.trace import span


def add_action_noise(actions: torch.Tensor, seed: int,
                     first_row: int = 0) -> torch.Tensor:
    """A jitter of up to 2 bins either way on move-to x/y and typed value.

    Applied to the raw batch actions, so both the teacher-forced inputs and
    the targets see the noise, matching the reference. The jitter of
    (row b, step t, slot j) is ``ops/prng.py:dropout_bits`` of ``seed`` at
    (``first_row`` + b, t, j) modulo 5, less 2: a data rank
    whose rows start at ``first_row`` of the global batch draws what one
    process draws for them, on any device and at any padded length.
    """
    # Deliberately UNCLAMPED, like the reference: a boundary value can
    # jitter to -1 (the pad sentinel: that step silently drops from the
    # loss) or past the top bin (999 + 2 = 1001, outside the vocab). Both
    # are rare edges the reference trains through; clamping would change
    # gradients against it.
    b, t = actions.shape[:2]
    bits = dropout_bits(seed, b, 1, t, 3, device=actions.device,
                        batch_offset=first_row, key_word=NOISE_KEY_WORD)
    jitter = (bits[:, 0] % 5 - 2).to(actions.dtype)          # (B, T, 3)

    cmd = actions[..., 0:1]
    xy = actions[..., 1:3] + jitter[..., 0:2] * (
        cmd == CMD_MOVE_TO).to(actions.dtype)
    typed = actions[..., 6:7] + jitter[..., 2:3] * (
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


def data_parallel(model, mesh):
    """``model`` under DDP over the mesh's data group with summed
    gradients (module docstring), or ``model`` itself without a process
    group."""
    if mesh is None or mesh.data_group is None:
        return model
    ddp = DistributedDataParallel(model, process_group=mesh.data_group,
                                  static_graph=True)
    ddp.register_comm_hook(mesh.data_group, sum_gradients_hook)
    return ddp


def make_train_step(model, loss_config: LossConfig, noise: bool = False,
                    mesh=None):
    """Returns train_step(state, batch, seed) -> (state, loss, metrics).

    ``batch`` holds tensors on the model's device; ``seed`` is an int, and
    the step's generators (action noise, dropout) are made from (seed,
    ``state.step``), so every step draws fresh masks and a run repeats
    exactly. The model's parameters (``state.params``) are updated in
    place; the loss and the metric counters stay on the device. With a
    ``mesh``, ``batch`` holds this rank's rows, and the loss is this rank's
    share of the global loss (the shares sum to it).
    """
    forward = data_parallel(model, mesh)
    data_group = None if mesh is None else mesh.data_group
    model_rank = None if mesh is None or mesh.model_size == 1 \
        else mesh.model_rank

    def train_step(state: TrainState, batch, seed: int):
        with span("step", state.step):
            return _step(state, batch, seed)

    def _step(state: TrainState, batch, seed: int):
        step_seed = fold_in(seed, state.step)
        device = model.device
        if noise:
            first_row = (0 if mesh is None else
                         mesh.data_rank * batch["actions"].shape[0])
            batch = dict(batch, actions=add_action_noise(
                batch["actions"], fold_in(step_seed, 0), first_row))
        dropout_seed = fold_in(step_seed, 1)
        if mesh is not None and mesh.data_size > 1:
            dropout_seed = fold_in(dropout_seed, mesh.data_rank)
        rng = DropoutRng(dropout_seed, device, model_rank)
        with span("step.forward", state.step):
            model_inputs, targets = prepare_model_inputs(batch)
            was_training = model.training
            model.train()
            try:
                cmd_logits, param_logits = forward(model_inputs, rng=rng)
            finally:
                model.train(was_training)
            loss, metrics = compute_loss_and_metrics(
                cmd_logits, param_logits, targets, loss_config, data_group)
        with span("step.backward", state.step):
            model.zero_grad(set_to_none=True)
            loss.backward()
        return state.apply_gradients(), loss.detach(), metrics

    return train_step


def make_eval_step(model, loss_config: LossConfig, ablate_cad: bool = False,
                   mesh=None):
    """Returns eval_step(batch) -> (loss, metrics): the teacher-forced
    evaluation of the model's current parameters, dropout off. With a
    ``mesh``, of this rank's rows, the loss as a share of the global
    loss."""
    data_group = None if mesh is None else mesh.data_group

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
                                        loss_config, data_group)

    return eval_step
