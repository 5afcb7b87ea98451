"""The training objective and accuracy counters for VideoCADFormer.

Port of ``videocad_tpu/train/objective.py``: the command loss and six
per-parameter losses combined as total = 2 * cmd_loss + sum(param losses),
and the metric counters as float32 scalars left on the device (derived
percentages are computed host-side in ``train/metrics.py``).

Two loss modes, selected by ``use_mse``:
  * ``use_mse=True``: flexible tolerance CE per parameter (no class
    weights), scaled by the command-class weight of the parameter's owning
    command;
  * ``use_mse=False``: 1000-bin class-weighted CE per parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from videocad_tpu_torch.actions.vocab import (
    NUM_COMMANDS,
    NUM_PARAMS,
    PARAM_ABOVE,
    PARAM_NAMES,
    PARAM_TOLERANCES,
    PARAM_TO_LABEL,
    TOLERANCE,
)
from videocad_tpu_torch.ops.losses import (flexible_cross_entropy,
                                           weighted_cross_entropy)

TOPK = 30  # "top-30": accuracy over the first 30 timesteps

# The reference's published command-class weights (class_weights.json
# "Label").
REFERENCE_CMD_WEIGHTS = (
    0.04332685213392362, 0.02915898563179938, 0.267566828114559,
    0.6005346809501417, 0.05941265316957628)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss configuration."""

    cmd_weights: Tuple[float, ...]  # class_weights.json "Label"
    use_mse: bool = True
    # Reproduce the reference's truthy-`above` quirk: the flexible CE always
    # runs one-sided. Set False to use the per-param PARAM_ABOVE flags.
    above_quirk: bool = True
    # Optional per-param 1000-bin class weights (use_mse=False path), by
    # param index; None = unweighted.
    param_bin_weights: Optional[Tuple[Optional[Tuple[float, ...]], ...]] = None

    @staticmethod
    def from_class_weights(weight_data: dict, use_mse: bool = True,
                           above_quirk: bool = True) -> "LossConfig":
        """Build from a class_weights.json-shaped dict."""
        if not isinstance(weight_data.get("Label"), (list, tuple)):
            raise ValueError(
                "class_weights 'Label' must be a list of 5 floats "
                "(reference class_weights.json format), got "
                f"{type(weight_data.get('Label')).__name__}")
        bins = tuple(
            tuple(weight_data[PARAM_NAMES[i + 1]])
            if PARAM_NAMES[i + 1] in weight_data else None
            for i in range(NUM_PARAMS))
        return LossConfig(
            cmd_weights=tuple(weight_data["Label"]),
            use_mse=use_mse,
            above_quirk=above_quirk,
            param_bin_weights=bins if not use_mse else None)


def _param_correct_counts(params_pred, params_target, correct_mask, use_mse,
                          t_slice=slice(None)):
    """Per-param correct counts under the tolerance rules."""
    counts = []
    pred = params_pred[:, t_slice]
    tgt = params_target[:, t_slice]
    msk = correct_mask[:, t_slice]
    for i in range(NUM_PARAMS):
        diff = pred[..., i] - tgt[..., i]
        if use_mse and PARAM_ABOVE[i]:
            ok = (diff >= 0) & (diff < PARAM_TOLERANCES[i])
        else:
            ok = diff.abs() < TOLERANCE
        counts.append((ok & msk[..., i]).sum())
    return counts


def compute_loss_and_metrics(
    cmd_logits: torch.Tensor,      # (B, T, 5)
    param_logits: torch.Tensor,    # (B, T, 6, 1000)
    target_actions: torch.Tensor,  # (B, T, 7) int (or float; cast like .long())
    config: LossConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    device = cmd_logits.device
    targets = target_actions.to(torch.int64)
    cmd_target = targets[..., 0]
    params_target = targets[..., 1:]

    cmd_w = torch.tensor(config.cmd_weights, dtype=torch.float32,
                         device=device)
    loss_cmd = weighted_cross_entropy(cmd_logits, cmd_target, cmd_w)

    loss_params = 0.0
    for i in range(NUM_PARAMS):
        logits_i = param_logits[..., i, :]
        target_i = params_target[..., i]
        if config.use_mse:
            above = True if config.above_quirk else PARAM_ABOVE[i]
            loss_i = flexible_cross_entropy(
                logits_i, target_i, tolerance=PARAM_TOLERANCES[i],
                above=above, ignore_valid=True)
        else:
            bins = None
            if (config.param_bin_weights
                    and config.param_bin_weights[i] is not None):
                bins = torch.tensor(config.param_bin_weights[i],
                                    dtype=torch.float32, device=device)
            loss_i = weighted_cross_entropy(logits_i, target_i, bins)
        # NaN guard, as the reference trainer has it (empty selections
        # already yield 0).
        loss_i = torch.where(torch.isnan(loss_i), 0.0, loss_i)
        loss_params = loss_params + loss_i * config.cmd_weights[
            PARAM_TO_LABEL[i]]

    loss = 2.0 * loss_cmd + loss_params

    # ---- accuracy counters ----
    cmd_pred = cmd_logits.argmax(dim=-1)
    params_pred = param_logits.argmax(dim=-1)

    cmd_mask = cmd_target != -1
    cmd_hit = cmd_pred == cmd_target
    cmd_correct = (cmd_hit & cmd_mask).sum()

    metrics: Dict[str, torch.Tensor] = {}
    for i in range(NUM_COMMANDS):
        mask_i = cmd_target == i
        metrics[f"cmd_corrects_{i}"] = (cmd_hit & mask_i).sum()
        metrics[f"cmd_counts_{i}"] = mask_i.sum()

    # param_valid: counted whenever the param is labeled; params_mask (for
    # "correct") additionally requires the command itself to be right.
    param_valid = cmd_mask[..., None] & (params_target != -1)
    params_mask = param_valid & cmd_hit[..., None]

    param_corrects = _param_correct_counts(
        params_pred, params_target, params_mask, config.use_mse)
    for i in range(NUM_PARAMS):
        metrics[f"param_corrects_{i}"] = param_corrects[i]
        metrics[f"param_counts_{i}"] = param_valid[..., i].sum()

    metrics["correct_predictions"] = cmd_correct + sum(param_corrects)
    metrics["total_predictions"] = cmd_mask.sum() + param_valid.sum()

    # Top-30: the first TOPK timesteps only.
    k = TOPK
    metrics["cmd_correct_topk"] = (cmd_hit[:, :k] & cmd_mask[:, :k]).sum()
    metrics["cmd_counts_topk"] = cmd_mask[:, :k].sum()
    if config.use_mse:
        metrics["param_correct_topk"] = sum(_param_correct_counts(
            params_pred, params_target, params_mask, True,
            t_slice=slice(0, k)))
    else:
        # Non-MSE top-30 uses exact equality.
        metrics["param_correct_topk"] = (
            (params_pred[:, :k] == params_target[:, :k])
            & params_mask[:, :k]).sum()
    metrics["param_counts_topk"] = param_valid[:, :k].sum()

    # Perfect-sequence counters: always zero in the reference; kept for
    # log-schema parity.
    zero = torch.zeros((), dtype=torch.float32, device=device)
    metrics["perfect_sequences"] = zero
    metrics["perfect_commands"] = zero
    metrics["total_sequences"] = zero

    metrics = {k_: v.to(torch.float32) for k_, v in metrics.items()}
    return loss, metrics
