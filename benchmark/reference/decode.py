"""Judging decoded actions against the reference's logits.

The published decode rule: the command and each parameter are the argmax
of their logits; a parameter the command does not use becomes -1, "times"
survives only for keys in [200, 250); the action fed back at the next step
is that vector normalized (cmd / 4, params / 1000), and all zeros at the
first step. The reference runs the whole sequence teacher-forced on the
served actions (one pass, no cache) and reads, for every served token, how
far its logit lies below the reference's best at that position.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import model as ref_model
from benchmark.reference.train import normalize
from benchmark.reference.vocab import ACTION_PARAM_MASK, KEY3_WINDOW


def mask_params(cmd: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """(..., ) commands and (..., 6) argmax parameters -> the masked
    parameters of the decode rule."""
    table = torch.tensor(ACTION_PARAM_MASK, device=cmd.device)
    valid = table[cmd.clamp(0, len(ACTION_PARAM_MASK) - 1)] > 0
    masked = torch.where(valid, params, torch.full_like(params, -1))
    key = masked[..., 2]
    keep_times = (key >= KEY3_WINDOW[0]) & (key < KEY3_WINDOW[1])
    masked[..., 3] = torch.where(keep_times, masked[..., 3],
                                 torch.full_like(key, -1))
    return masked


def fed_back(actions: torch.Tensor) -> torch.Tensor:
    """Served integer actions (B, T, 7), -1 where masked -> the decoder's
    action inputs (B, T, 7): zeros, then each step's normalized action."""
    inputs = normalize(actions)
    return torch.cat([torch.zeros_like(inputs[:, :1]), inputs[:, :-1]], dim=1)


@torch.no_grad()
def token_gaps(params: Dict, cfg: Dict, frames: torch.Tensor,
               cad_image: torch.Tensor, actions: torch.Tensor,
               param_tokens: torch.Tensor = None,
               control: bool = False) -> torch.Tensor:
    """The gap of every served token under the reference, flattened.

    frames uint8 (B, T, H, W, 3) as served, cad_image uint8 (B, ...),
    actions (B, T, 7) the served masked actions; ``param_tokens`` (B, T, 6)
    the unmasked parameter argmaxes where the program returns them (the
    rollout), else the served parameters other than -1 are judged.
    ``control``: judge instead the tokens that the reference computed in
    fp8 (``model.LowPrecision``) puts first at the same positions, on the
    same inputs and fed-back actions."""
    inputs = fed_back(actions)
    cmd_logits, par_logits = ref_model.forward(params, cfg, frames, inputs,
                                               cad_image)
    cmd = actions[..., 0].long()
    tokens = (param_tokens if param_tokens is not None
              else actions[..., 1:]).long()
    if control:
        low_cmd, low_par = ref_model.forward(ref_model.LowPrecision(params),
                                             cfg, frames, inputs, cad_image)
        cmd = low_cmd.argmax(dim=-1)
        tokens = torch.where(tokens >= 0, low_par.argmax(dim=-1), tokens)
    cmd_gap = (cmd_logits.max(dim=-1).values
               - cmd_logits.gather(-1, cmd[..., None])[..., 0])
    best = par_logits.max(dim=-1).values
    picked = par_logits.gather(-1, tokens.clamp(min=0)[..., None])[..., 0]
    param_gap = best - picked
    return torch.cat([cmd_gap.reshape(-1), param_gap[tokens >= 0]])


def gap_stats(gaps: torch.Tensor) -> dict:
    """The widest gap of the served tokens, and how many were judged."""
    return {"token_gap": float(gaps.max()), "tokens": int(gaps.numel())}
