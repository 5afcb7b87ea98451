"""Incremental (frame-at-a-time) decode for serving one session.

Port of ``videocad_tpu/infer/incremental.py``. The batch rollout
(``infer/rollout.py``) takes every ground-truth frame up front; a live
CAD-UI agent receives the frames one by one as its actions execute:

  params = prepare_for_decode(model)          # or quantize_for_decode
  carry = init_decode_carry(model, cad_image, seq_len)
  for frame in ui_stream:                     # (B, H, W, C) uint8
      carry, cmd_logits, param_logits = incremental_decode_step(
          model, params, frame, carry)
      # carry["action"] is the masked, normalized action to execute next

Each step (1) encodes the new frame and writes its memory K/V slot into
every layer's cross-attention cache, (2) runs one KV-cached decoder step
(``rollout.decode_step``) on the previous action, (3) argmax-decodes,
masks and normalizes the next action (``rollout.next_actions``). Driving T
steps equals the batch rollout. The lane-multiplexed serving step
(``infer/multiplex.py``) runs the same body, :func:`advance`, with a
position and a write gate per lane.

The JAX step donates its carry; this one updates the caches IN PLACE and
replaces ``t`` and ``action`` in the carry it returns, which is the same
dict. Past ``seq_len`` steps the carry is bit-frozen, and the returned
logits are garbage by contract.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from videocad_tpu_torch.actions.vocab import ACT_DIM
from videocad_tpu_torch.infer.rollout import (_dense, _kv_write,
                                              cast_decode_tree, decode_step,
                                              kv_caches, next_actions)


def _require_incremental_support(cfg) -> None:
    if not cfg.enable_past_actions:
        raise ValueError(
            "incremental decode needs enable_past_actions=True: without "
            "action feedback the model has no sequential dependency; use "
            "the one-pass forward (infer/rollout.py handles this mode)")


@torch.no_grad()
def init_decode_carry(model: nn.Module, cad_image: torch.Tensor,
                      seq_len: int,
                      multiview_images: Optional[torch.Tensor] = None
                      ) -> Dict:
    """Encode the CAD context once and allocate the decode caches on the
    model's device:

      t () int64            the session's step counter
      action (B, 7) f32     the previous action (the zero-action start)
      cad_stream (B, W)     ``encode_cad_stream``'s constant features
      self_kv / mem_kv      per-layer (B, seq_len, H, D) caches
    """
    cfg = model.config
    _require_incremental_support(cfg)
    device = model.device
    cad_image = torch.as_tensor(cad_image, device=device)
    if multiview_images is not None:
        multiview_images = torch.as_tensor(multiview_images, device=device)
    b = cad_image.shape[0]
    return {
        "t": torch.zeros((), dtype=torch.int64, device=device),
        "action": torch.zeros((b, ACT_DIM), device=device),
        "cad_stream": model.encode_cad_stream(cad_image, multiview_images),
        "self_kv": kv_caches(cfg, b, seq_len, device),
        "mem_kv": kv_caches(cfg, b, seq_len, device),
    }


def advance(model: nn.Module, params: Dict, frames: torch.Tensor,
            t: torch.Tensor, valid: torch.Tensor, carry: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of every row at its own position ``t`` (B,), the
    body the single-session and the multiplexed steps share. The new
    frames' memory K/V (projected with ``params``' cross-attention
    key/value: float32 from ``prepare_for_decode``, integers from
    ``quantize_for_decode``) and the step's self K/V are written into the
    carry's caches in place where ``valid`` (B,) holds. Returns (next
    actions (B, 7), cmd logits (B, 5), param logits (B, 6, 1000))."""
    cfg = model.config
    dtype = cfg.compute_dtype
    seq_len = carry["self_kv"][0][0].shape[1]
    rows = frames.shape[0]
    mem_t = model.encode_memory_step(frames, t, carry["cad_stream"]).to(dtype)
    for i in range(cfg.num_decoder_layers):
        ca = params["decoder"][f"layers_{i}"]["cross_attn"]
        k_cache, v_cache = carry["mem_kv"][i]
        _kv_write(k_cache, _dense(ca["key"], mem_t).to(dtype).reshape(
            rows, cfg.nhead, -1), t, valid)
        _kv_write(v_cache, _dense(ca["value"], mem_t).to(dtype).reshape(
            rows, cfg.nhead, -1), t, valid)

    x = torch.tanh(_dense(cast_decode_tree(params["embed_action"], dtype),
                          carry["action"].to(dtype)) + model._timestep(t))
    hidden, _ = decode_step(params, cfg, x, t, carry["self_kv"],
                            carry["mem_kv"], cfg.window_size, seq_len,
                            write_valid=valid)
    hidden = hidden.to(torch.float32)
    cmd_logits = _dense(params["predict_cmd"], hidden)
    param_logits = _dense(params["predict_params"], hidden).reshape(
        rows, cfg.num_params, cfg.num_params_values)
    return next_actions(cmd_logits, param_logits), cmd_logits, param_logits


@torch.no_grad()
def incremental_decode_step(model: nn.Module, params: Dict,
                            frame: torch.Tensor, carry: Dict
                            ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """One serving step: observe ``frame`` (B, H, W, C uint8) and predict
    an action. ``params`` comes from ``rollout.prepare_for_decode`` or
    ``rollout.quantize_for_decode``.

    Returns (carry, cmd_logits (B, 5), param_logits (B, 6, 1000));
    ``carry["action"]`` is the next action, as the batch rollout feeds it
    back. The counter stays on the device: no step reads it on the host.
    """
    _require_incremental_support(model.config)
    seq_len = carry["self_kv"][0][0].shape[1]
    frame = torch.as_tensor(frame, device=model.device)
    rows = frame.shape[0]
    # Horizon guard: past seq_len every write keeps its old value.
    valid = carry["t"] < seq_len
    t = carry["t"].clamp(max=seq_len - 1)
    action, cmd_logits, param_logits = advance(
        model, params, frame, t.expand(rows), valid.expand(rows), carry)
    carry["action"] = torch.where(valid, action, carry["action"])
    carry["t"] = torch.where(valid, carry["t"] + 1, carry["t"])
    return carry, cmd_logits, param_logits
