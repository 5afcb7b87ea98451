"""Ops over action tensors: normalization and per-command param masking.

Port of ``videocad_tpu/actions/ops.py``; same semantics, on torch tensors.
"""

from __future__ import annotations

import functools

import torch

from videocad_tpu_torch.actions.vocab import (
    ACTION_PARAM_MASK,
    KEY3_WINDOW_HI,
    KEY3_WINDOW_LO,
    NUM_COMMANDS,
)


def normalize_actions(actions: torch.Tensor) -> torch.Tensor:
    """Scale integer actions to model-input floats: cmd/4, params/1000.

    Input shape (..., 7); -1 sentinels become -0.25 / -0.001.
    """
    actions = actions.to(torch.float32)
    return torch.cat([actions[..., :1] / 4.0, actions[..., 1:] / 1000.0],
                     dim=-1)


@functools.lru_cache(maxsize=8)
def _mask_table(device: torch.device) -> torch.Tensor:
    # One copy per device: a host-to-device copy inside the decode loop
    # would synchronise every step.
    return torch.tensor(ACTION_PARAM_MASK, dtype=torch.float32, device=device)


def param_validity_mask(cmd: torch.Tensor) -> torch.Tensor:
    """Per-command param validity, shape cmd.shape + (6,), float {0,1}."""
    return _mask_table(cmd.device)[cmd.clamp(0, NUM_COMMANDS - 1)]


def apply_action_mask(cmd_pred: torch.Tensor,
                      param_pred: torch.Tensor) -> torch.Tensor:
    """Invalidate params not used by the predicted command.

    Params where the command's mask is 0 become -1; param 3 survives only
    when the (already masked) param 2 lies in [KEY3_WINDOW_LO,
    KEY3_WINDOW_HI). cmd_pred: (...,) int; param_pred: (..., 6) int.
    """
    mask = param_validity_mask(cmd_pred)
    masked = torch.where(mask == 0, torch.full_like(param_pred, -1),
                         param_pred)
    key = masked[..., 2]
    times_ok = (key >= KEY3_WINDOW_LO) & (key < KEY3_WINDOW_HI)
    times = torch.where(times_ok, masked[..., 3],
                        torch.full_like(masked[..., 3], -1))
    return torch.cat([masked[..., :3], times[..., None], masked[..., 4:]],
                     dim=-1)
