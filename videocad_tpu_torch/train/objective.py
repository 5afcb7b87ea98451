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

Under data parallelism (``data_group``) each rank holds some rows of the
global batch, and each loss is still one weighted mean over the whole
batch, as JAX's is: the rank divides its local numerator by the
denominator all-reduced over the group (no gradient flows through that
reduction), the NaN guard and the "0 when empty" rule act on the global
quantities, and the ranks' losses and gradients are summed, not averaged
(``parallel/collectives.py:sum_gradients_hook``). The metric counters stay
the rank's own; the trainer sums them when it fetches them.
"""

from __future__ import annotations

import dataclasses
import functools
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
from videocad_tpu_torch.ops.losses import (flexible_cross_entropy_terms,
                                           weighted_cross_entropy_terms)
from videocad_tpu_torch.parallel.collectives import all_reduce

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


@functools.lru_cache(maxsize=16)
def _weights_on(weights: Tuple[float, ...], device: torch.device
                ) -> torch.Tensor:
    """``weights`` as a float32 tensor on ``device``, made once: a tensor
    built from host values on every step would copy them to the card with
    a synchronising copy and stall the training loop. The one copy goes
    from pinned memory without a synchronisation too, since the first step
    of an epoch may be the first to ask for a class-weights file's
    numbers."""
    host = torch.tensor(weights, dtype=torch.float32)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


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


def _means(terms, data_group) -> torch.Tensor:
    """The losses ``num / den`` of (numerator, denominator) pairs, 0 where
    the denominator is 0, with the denominators summed over
    ``data_group`` first. Entries 1.. (the parameters') get the NaN guard,
    as the reference trainer has it, on the global value: with a group,
    one rank's NaN numerator zeroes that loss on every rank."""
    nums = torch.stack([n for n, _ in terms])
    dens = torch.stack([d.to(torch.float32) for _, d in terms])
    if data_group is not None:
        stats = all_reduce(torch.cat([dens, torch.isnan(nums).to(
            torch.float32)]), data_group)
        dens, nan = stats[:len(terms)], stats[len(terms):] > 0
    losses = torch.where(dens > 0, nums / dens.clamp(min=1e-20), 0.0)
    if data_group is None:
        nan = torch.isnan(losses)
    guarded = torch.where(nan, 0.0, losses)
    return torch.cat([losses[:1], guarded[1:]])


def compute_loss_and_metrics(
    cmd_logits: torch.Tensor,      # (B, T, 5)
    param_logits: torch.Tensor,    # (B, T, 6, 1000)
    target_actions: torch.Tensor,  # (B, T, 7) int (or float; cast like .long())
    config: LossConfig,
    data_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the metric counters of this batch, or, with
    ``data_group``, of this rank's rows (module docstring)."""
    device = cmd_logits.device
    targets = target_actions.to(torch.int64)
    cmd_target = targets[..., 0]
    params_target = targets[..., 1:]

    cmd_w = _weights_on(tuple(config.cmd_weights), device)
    terms = [weighted_cross_entropy_terms(cmd_logits, cmd_target, cmd_w)]
    for i in range(NUM_PARAMS):
        logits_i = param_logits[..., i, :]
        target_i = params_target[..., i]
        if config.use_mse:
            above = True if config.above_quirk else PARAM_ABOVE[i]
            terms.append(flexible_cross_entropy_terms(
                logits_i, target_i, tolerance=PARAM_TOLERANCES[i],
                above=above, ignore_valid=True))
        else:
            bins = None
            if (config.param_bin_weights
                    and config.param_bin_weights[i] is not None):
                bins = _weights_on(tuple(config.param_bin_weights[i]),
                                   device)
            terms.append(weighted_cross_entropy_terms(logits_i, target_i,
                                                      bins))
    losses = _means(terms, data_group)
    loss_params = 0.0
    for i in range(NUM_PARAMS):
        loss_params = loss_params + losses[i + 1] * config.cmd_weights[
            PARAM_TO_LABEL[i]]

    loss = 2.0 * losses[0] + loss_params

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
