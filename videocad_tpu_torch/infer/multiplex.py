"""Lane-multiplexed incremental decode: concurrent serving sessions in one
batch.

Port of ``videocad_tpu/infer/multiplex.py``. The decode carry holds
per-lane state (step counters, KV write positions, CAD context), so up to
``lanes`` concurrent sessions share one decoder weight stream per step:
continuous batching for the decode loop.

  * cache writes land at each lane's own ``t``;
  * the causal self mask and the banded memory window are per lane;
  * an ``active`` mask gates every state write, so a step for lane i leaves
    all other lanes bit-frozen.

The JAX programs donate the carry; here the KV caches are updated IN PLACE
under the ``active`` mask (an inactive lane's slot is rewritten with its
own value), and ``t`` / ``action`` are replaced by their gated successors.
Use the returned carry; it is the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from videocad_tpu_torch.actions.vocab import ACT_DIM
from videocad_tpu_torch.infer.incremental import (
    _require_incremental_support, advance)
from videocad_tpu_torch.infer.rollout import kv_caches


def init_mux_carry(model: nn.Module, lanes: int, seq_len: int,
                   device=None, multiview: bool = False) -> Dict:
    """Allocate an all-lanes-idle carry for ``lanes`` concurrent sessions
    on ``device`` (default: the model's):

      t (L,) int64          per-lane step counter
      active (L,) bool      lane occupancy (gates every state write)
      action (L, 7) f32     per-lane previous action (zero-action start)
      cad_stream (L, W)     per-lane constant CAD features: W = hidden, or
                            2 * hidden when ``multiview`` and the model has
                            views (the sessions then bring their
                            multiview images)
      self_kv / mem_kv      per-layer (L, seq_len, H, D) caches
    """
    cfg = model.config
    _require_incremental_support(cfg)
    device = torch.device(device) if device is not None else model.device
    streams = 2 if multiview and cfg.num_views > 0 else 1
    return {
        "t": torch.zeros((lanes,), dtype=torch.int64, device=device),
        "active": torch.zeros((lanes,), dtype=torch.bool, device=device),
        "action": torch.zeros((lanes, ACT_DIM), device=device),
        "cad_stream": torch.zeros((lanes, streams * cfg.hidden_size),
                                  dtype=cfg.compute_dtype, device=device),
        "self_kv": kv_caches(cfg, lanes, seq_len, device),
        "mem_kv": kv_caches(cfg, lanes, seq_len, device),
    }


@torch.no_grad()
def open_lane(model: nn.Module, carry: Dict, lane: int,
              cad_image: torch.Tensor,
              multiview_images: Optional[torch.Tensor] = None) -> Dict:
    """Claim ``lane`` for a new session: encode its CAD context (batch 1,
    once per session: the CAD image (1, H, W, C), and the multiview images
    (1, V, H, W, C) of a multiview carry) and reset the lane's counter,
    action and caches, in place. Other lanes' state is untouched."""
    cad_stream = model.encode_cad_stream(cad_image,
                                         multiview_images)     # (1, W)
    carry["t"][lane] = 0
    carry["active"][lane] = True
    carry["action"][lane] = 0.0
    carry["cad_stream"][lane] = cad_stream[0].to(carry["cad_stream"].dtype)
    for k, v in carry["self_kv"] + carry["mem_kv"]:
        k[lane] = 0
        v[lane] = 0
    return carry


def close_lane(carry: Dict, lane: int) -> Dict:
    """Release a lane. Its stale state is inert: every write is gated on
    ``active`` and :func:`open_lane` resets it."""
    carry["active"][lane] = False
    return carry


@torch.no_grad()
def mux_decode_step(model: nn.Module, params: Dict, frames: torch.Tensor,
                    active: torch.Tensor, carry: Dict
                    ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """One multiplexed step: each lane in ``active`` observes its row of
    ``frames`` (L, H, W, C uint8) and advances one step; inactive lanes are
    bit-frozen. ``params`` comes from ``rollout.prepare_for_decode`` or
    ``rollout.quantize_for_decode``; the step is ``incremental.advance``
    with each lane's own position.

    Returns (carry, cmd_logits (L, 5), param_logits (L, 6, 1000)); logits
    rows of inactive lanes are garbage by contract.
    """
    _require_incremental_support(model.config)
    t = carry["t"]
    seq_len = carry["self_kv"][0][0].shape[1]
    # Horizon guard: a lane stepped at t >= seq_len stays bit-frozen.
    active = active & carry["active"] & (t < seq_len)
    action, cmd_logits, param_logits = advance(model, params, frames, t,
                                               active, carry)
    carry["action"] = torch.where(active[:, None], action, carry["action"])
    carry["t"] = torch.where(active, t + 1, t)
    return carry, cmd_logits, param_logits
