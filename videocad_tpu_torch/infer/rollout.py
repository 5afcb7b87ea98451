"""Autoregressive rollout: a KV-cached decode over the 186-step horizon.

Port of ``videocad_tpu/infer/rollout.py``. The ground-truth frames are
encoded once, the cross-attention K/V of the memory are projected once per
layer, and each step runs one KV-cached decoder step on the previous
action: argmax-decoded, masked per command, normalized and fed back (the
reference's decode rule).

The decode math runs on plain nested dicts of tensors (the model's
parameters by their JAX-tree names, see :func:`param_tree`): a dense layer
is ``{"weight": (out, in), "bias": (out,)}`` and a LayerNorm is
``{"weight", "bias"}``. :func:`decode_step` is shared with the
lane-multiplexed serving step (``infer/multiplex.py``): it takes a scalar
position ``t`` (all rows at one position) or a per-row (B,) ``t``.

JAX's decode step returns new caches; this one writes the step's K and V
into the caches IN PLACE (the JAX programs donate the carry for the same
effect), gated by ``write_valid``.

``weight_quant`` ("int8" / "int4") streams the decoder's dense weights as
integers with a per-output-channel scale (:func:`quantize_decode_weights`),
dequantized at the read in JAX's order, ``(x @ q^T) * scale + bias``. An
int8 dense is ``{"weight_q": int8 (out, in), "scale", "bias"}``; an int4
dense packs two's-complement nibbles two to a byte along the input axis,
``{"weight_q4": uint8 (out, ceil(in / 2)), "in_features": in, "scale",
"bias"}`` (torch has no int4 dtype). The encoders, embeddings and heads
stay full precision.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from videocad_tpu_torch.actions.ops import apply_action_mask, normalize_actions
from videocad_tpu_torch.actions.vocab import ACT_DIM

KV = List[Tuple[torch.Tensor, torch.Tensor]]


def param_tree(module: nn.Module) -> Dict:
    """The module's parameters as nested dicts, split on ``.``; the leaves
    share storage with the module's parameters."""
    tree: Dict = {}
    for name, p in module.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach()
    return tree


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 (out, in) values in [-8, 7] -> uint8 (out, ceil(in / 2)): two's
    complement nibbles, column 2j in the low nibble of byte j and column
    2j + 1 in the high one; an odd width is padded with a zero."""
    if q.shape[1] % 2:
        q = F.pad(q, (0, 1))
    nibbles = q.to(torch.int16) & 0xF
    return (nibbles[:, 0::2] | (nibbles[:, 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, in_features: int) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: int8 (out, in_features)."""
    b = packed.to(torch.int16)
    nibbles = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(
        packed.shape[0], -1)[:, :in_features]
    return (nibbles - ((nibbles & 0x8) << 1)).to(torch.int8)


def dequantized_weight(p: Dict) -> torch.Tensor:
    """A quantized dense's integers as int8 (out, in), before the scale."""
    if "weight_q4" in p:
        return unpack_int4(p["weight_q4"], p["in_features"])
    return p["weight_q"]


def _dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with JAX's type promotion: a bfloat16 x against
    float32 weights computes in float32. A quantized dense (w8a16 / w4a16)
    multiplies by its integers cast to x's dtype, then scales each output
    channel and adds the bias, as JAX's ``_dense`` does."""
    if "scale" in p:
        y = F.linear(x, dequantized_weight(p).to(x.dtype))
        return y * p["scale"] + p["bias"]
    w = p["weight"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.linear(x.to(dt), w.to(dt))
    return y + p["bias"] if "bias" in p else y


def cast_decode_tree(tree, dtype: torch.dtype):
    """Cast every floating leaf of a decode tree to ``dtype``; integer
    weights (and an int4 dense's recorded width) pass through, so a tree
    quantized by :func:`quantize_decode_weights` survives the dtype flow."""
    if isinstance(tree, dict):
        return {k: cast_decode_tree(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


# The decoder's dense layers that weight-only quantization streams as
# integers (JAX's ``_DENSE_KEYS``).
_DENSE_KEYS = ("query", "key", "value", "out", "linear1", "linear2")
QUANT_BITS = {"int8": 8, "int4": 4}


def quantize_dense(p: Dict, dtype: torch.dtype, bits: int) -> Dict:
    """Per-output-channel symmetric quantization of one dense, in the
    arithmetic of JAX's compiled ``quantize_decode_weights`` on the CPU:
    XLA turns ``max / qmax`` into a product with the float32 reciprocal of
    qmax, and the integers are ``round(w / scale)`` (half to even),
    clipped to +-qmax. The scale is then stored in ``dtype``."""
    qmax = {8: 127.0, 4: 7.0}[bits]
    w = p["weight"].to(torch.float32)                       # (out, in)
    inv = torch.tensor(1.0, device=w.device) / qmax
    scale = w.abs().amax(dim=1).clamp_min(1e-12) * inv
    q = torch.round(w / scale[:, None]).clamp(-qmax, qmax).to(torch.int8)
    out = {"scale": scale.to(dtype), "bias": p["bias"].to(dtype)}
    if bits == 4:
        out.update(weight_q4=pack_int4(q), in_features=w.shape[1])
    else:
        out["weight_q"] = q
    return out


def quantize_decode_weights(decoder_tree: Dict, dtype: torch.dtype,
                            bits: int = 8) -> Dict:
    """The decoder subtree with every dense of ``_DENSE_KEYS`` quantized
    (:func:`quantize_dense`) and every other leaf (LayerNorm affines) cast
    to ``dtype``. Nothing outside the decoder is read or copied."""
    def walk(node, name=None):
        if isinstance(node, dict):
            if name in _DENSE_KEYS and "weight" in node:
                return quantize_dense(node, dtype, bits)
            return {k: walk(v, k) for k, v in node.items()}
        return node.to(dtype)
    return walk(decoder_tree)


def _cat_rows(leaves):
    """Concatenate one key of q, k and v along the output axis; an int4
    dense's width (the model's, for all three) is kept once."""
    return torch.cat(leaves, dim=0) if torch.is_tensor(leaves[0]) else leaves[0]


def fuse_self_qkv(decoder_tree: Dict) -> Dict:
    """Concatenate each layer's self-attention query/key/value into one
    ``qkv`` dense (rows of the torch-layout weight), so the latency-bound
    decode loop runs one product instead of three per layer. Quantized
    denses fuse the same way: integers, packed int4 bytes (packed along the
    input axis) and per-channel scales are all rows."""
    out = dict(decoder_tree)
    for name, layer in decoder_tree.items():
        if not name.startswith("layers_") or "qkv" in layer["self_attn"]:
            continue
        sa = dict(layer["self_attn"])
        parts = [sa.pop("query"), sa.pop("key"), sa.pop("value")]
        sa["qkv"] = {k: _cat_rows([p[k] for p in parts]) for k in parts[0]}
        out[name] = dict(layer, self_attn=sa)
    return out


def prepare_for_decode(model: nn.Module,
                       dtype: Optional[torch.dtype] = None) -> Dict:
    """The model's parameter tree with its decoder cast to the compute
    dtype and its self-attention q/k/v fused. Run once per serving
    session.

    The cross-attention key/value weights keep their ORIGINAL precision:
    the serving step projects each new frame's memory K/V with them, and
    the batch rollout does that projection with the float32 weights (then
    casts), so serving and rollout stay step-for-step equal. The decoder
    step itself never reads them.
    """
    dtype = dtype or model.config.compute_dtype
    tree = param_tree(model)
    dec = fuse_self_qkv(cast_decode_tree(tree["decoder"], dtype))
    for name, layer in tree["decoder"].items():
        ca = dict(dec[name]["cross_attn"])
        ca["key"] = layer["cross_attn"]["key"]
        ca["value"] = layer["cross_attn"]["value"]
        dec[name] = dict(dec[name], cross_attn=ca)
    return dict(tree, decoder=dec)


def quantize_for_decode(model: nn.Module,
                        dtype: Optional[torch.dtype] = None,
                        bits: int = 8) -> Dict:
    """:func:`prepare_for_decode`'s quantized counterpart: the parameter
    tree with its decoder quantized to ``bits`` (8 or 4) and its
    self-attention q/k/v fused; run once per serving session. The memory
    K/V are projected with the quantized cross-attention key/value, as the
    quantized batch rollout projects them."""
    dtype = dtype or model.config.compute_dtype
    tree = param_tree(model)
    return dict(tree, decoder=fuse_self_qkv(
        quantize_decode_weights(tree["decoder"], dtype, bits)))


def decode_params(model: nn.Module, weight_quant: str = "none") -> Dict:
    """The session's decode tree for ``weight_quant`` ("none", "int8",
    "int4"): :func:`prepare_for_decode` or :func:`quantize_for_decode`."""
    check_weight_quant(model.config, weight_quant)
    if weight_quant == "none":
        return prepare_for_decode(model)
    return quantize_for_decode(model, bits=QUANT_BITS[weight_quant])


def check_weight_quant(cfg, weight_quant: str) -> None:
    """Refuse what JAX refuses: an unknown mode, and a quantized mode for a
    config without action feedback, which has no decode loop to quantize."""
    if weight_quant not in ("none",) + tuple(QUANT_BITS):
        raise ValueError(f"unknown weight_quant {weight_quant!r} (expected "
                         "'none', 'int8' or 'int4')")
    if weight_quant != "none" and not cfg.enable_past_actions:
        raise ValueError(
            f"weight_quant='{weight_quant}' requires action feedback "
            "(enable_past_actions): without it the rollout is a single "
            "full-precision forward and the quantized decode loop never "
            "runs")


def _layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, affine in the stream dtype."""
    f32 = x.to(torch.float32)
    mean = f32.mean(dim=-1, keepdim=True)
    var = ((f32 - mean) ** 2).mean(dim=-1, keepdim=True)
    norm = ((f32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return norm * p["weight"] + p["bias"]


def _heads_split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, inner = x.shape
    return x.reshape(b, num_heads, inner // num_heads)


def _masked_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); k,v: (B,S,H,D); mask: (S,) or per-row (B,S) bool.
    -> (B, H*D)."""
    scores = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(q.shape[-1])
    mask2d = mask if mask.dim() == 2 else mask[None, :]
    scores = scores.masked_fill(~mask2d[:, None, :],
                                torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhs,bshd->bhd", weights, v)
    return ctx.reshape(q.shape[0], -1)


Position = Union[int, torch.Tensor]


def _kv_write(cache: torch.Tensor, new: torch.Tensor, t: Position,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write one step's K or V into ``cache`` (B,T,H,D) at ``t``, in place.

    ``t``: an int (one position for all rows) or a (B,) tensor (per-row
    positions, clamped into the cache as JAX's dynamic_update_slice
    clamps). Where ``valid`` (a bool scalar, or (B,) with a per-row
    ``t``) is False the slot keeps its value.
    """
    if isinstance(t, int):
        if valid is not None:
            new = torch.where(valid, new, cache[:, t])
        cache[:, t] = new
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = t.clamp(0, cache.shape[1] - 1)
    if valid is not None:
        new = torch.where(valid[:, None, None], new, cache[rows, idx])
    cache[rows, idx] = new
    return cache


def _window_read(mem: torch.Tensor, start: Position, w: int) -> torch.Tensor:
    """Banded window read of the memory K/V: (B,S,H,D) -> (B,w,H,D)."""
    if isinstance(start, int):
        return mem[:, start:start + w]
    idx = start[:, None] + torch.arange(w, device=mem.device)[None, :]
    rows = torch.arange(mem.shape[0], device=mem.device)[:, None]
    return mem[rows, idx]


def kv_caches(cfg, rows: int, seq_len: int, device) -> KV:
    """Zeroed per-layer (k, v) caches, (rows, seq_len, heads, head width)
    each, in the compute dtype."""
    shape = (rows, seq_len, cfg.nhead, cfg.hidden_size // cfg.nhead)
    return [tuple(torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                  for _ in range(2))
            for _ in range(cfg.num_decoder_layers)]


def precompute_memory_kv(params: Dict, memory: torch.Tensor, num_layers: int,
                         num_heads: int) -> KV:
    """Project cross-attention K/V for every layer once: [(B,S,H,D)] x L."""
    mem_kv = []
    for i in range(num_layers):
        layer = params["decoder"][f"layers_{i}"]["cross_attn"]
        k = _dense(layer["key"], memory)
        v = _dense(layer["value"], memory)
        b, s, inner = k.shape
        mem_kv.append((k.reshape(b, s, num_heads, inner // num_heads),
                       v.reshape(b, s, num_heads, inner // num_heads)))
    return mem_kv


def decode_step(params: Dict, cfg, x: torch.Tensor, t: Position,
                self_kv: KV, mem_kv: KV, window: int, seq_len: int,
                write_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KV]:
    """One decoder-stack step at position ``t``.

    x: (B, hidden) target embedding for this step; self_kv: per-layer
    (k, v) caches (B, T, H, D), which receive this step's K/V in place;
    mem_kv: per-layer memory K/V. Returns (hidden_out, self_kv).

    ``t`` is an int (or 0-d tensor) for all rows at one position (the
    rollout), or a (B,) tensor for each serving lane at its own position.
    ``write_valid`` gates the self-KV write: a bool scalar for a scalar
    ``t`` (the horizon guard), or the (B,) active-lane mask for a per-row
    ``t``, which keeps idle lanes' caches bit-frozen.

    Cross-attention reads only the ``window``-wide slice of the memory K/V
    that the banded mask admits: positions (t - window, t].
    """
    num_heads = cfg.nhead
    device = x.device
    per_lane = torch.is_tensor(t) and t.dim() == 1
    if not per_lane:
        t = int(t)
    positions = torch.arange(seq_len, device=device)
    w = min(window, seq_len)
    if per_lane:
        start = (t - window + 1).clamp(0, seq_len - w)
        self_mask = positions[None, :] <= t[:, None]                # (B, S)
        wpos = start[:, None] + torch.arange(w, device=device)[None, :]
        mem_mask = (wpos > (t - window)[:, None]) & (wpos <= t[:, None])
    else:
        start = min(max(t - window + 1, 0), seq_len - w)
        self_mask = positions <= t                                  # (S,)
        wpos = start + torch.arange(w, device=device)
        mem_mask = (wpos > t - window) & (wpos <= t)

    for i in range(cfg.num_decoder_layers):
        layer = params["decoder"][f"layers_{i}"]
        sa, ca = layer["self_attn"], layer["cross_attn"]
        if "qkv" in sa:
            q, k_t, v_t = (_heads_split(part, num_heads)
                           for part in _dense(sa["qkv"], x).chunk(3, dim=-1))
        else:
            q = _heads_split(_dense(sa["query"], x), num_heads)
            k_t = _heads_split(_dense(sa["key"], x), num_heads)
            v_t = _heads_split(_dense(sa["value"], x), num_heads)
        k_cache, v_cache = self_kv[i]
        _kv_write(k_cache, k_t, t, write_valid)
        _kv_write(v_cache, v_t, t, write_valid)

        ctx = _masked_attend(q, k_cache, v_cache, self_mask)
        x = _layernorm(layer["norm1"], x + _dense(sa["out"], ctx))

        qc = _heads_split(_dense(ca["query"], x), num_heads)
        mem_k, mem_v = mem_kv[i]
        ctx = _masked_attend(qc, _window_read(mem_k, start, w),
                             _window_read(mem_v, start, w), mem_mask)
        x = _layernorm(layer["norm2"], x + _dense(ca["out"], ctx))

        h = torch.relu(_dense(layer["linear1"], x))
        x = _layernorm(layer["norm3"], x + _dense(layer["linear2"], h))
    return x, self_kv


def next_actions(cmd_logits: torch.Tensor,
                 param_logits: torch.Tensor) -> torch.Tensor:
    """The reference decode rule: argmax, per-command mask, normalize.
    -> (B, 7) float32."""
    cmd_pred = cmd_logits.argmax(dim=-1)
    masked = apply_action_mask(cmd_pred, param_logits.argmax(dim=-1))
    return normalize_actions(torch.cat([cmd_pred[:, None], masked], dim=-1))


@torch.no_grad()
def sequential_inference(model: nn.Module, frames: torch.Tensor,
                         cad_image: torch.Tensor, action: bool = True,
                         weight_quant: str = "none",
                         multiview_images: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step rollout (reference API).

    frames: (B, T, H, W, C) ground-truth UI frames (uint8 or normalized
    float); cad_image: (B, H, W, C); multiview_images: (B, V, H, W, C) for
    a multiview model. All move to the model's device. Returns ((B, T, 5)
    cmd logits, (B, T, 6, 1000) param logits): each step's logits.

    A model without action feedback (``enable_past_actions`` off, the
    decision transformer too) has no sequential dependency: one
    teacher-forced pass gives every step's logits.

    ``weight_quant`` "int8" / "int4" streams the decoder's dense weights as
    integers (:func:`quantize_decode_weights`), and projects the memory K/V
    with the quantized cross-attention key/value, as JAX does.
    """
    cfg = model.config
    check_weight_quant(cfg, weight_quant)
    device = model.device
    frames = torch.as_tensor(frames, device=device)
    cad_image = torch.as_tensor(cad_image, device=device)
    if multiview_images is not None:
        multiview_images = torch.as_tensor(multiview_images, device=device)
    b, seq_len = frames.shape[:2]

    if not cfg.enable_past_actions:
        inputs = {"frames": frames, "cad_image": cad_image,
                  "actions": torch.zeros((b, seq_len, ACT_DIM),
                                         device=device)}
        if multiview_images is not None:
            inputs["multiview_images"] = multiview_images
        return model(inputs)

    memory, _ = model.encode_context(cad_image, frames, multiview_images,
                                     seq_len)
    dtype = cfg.compute_dtype
    params = param_tree(model)
    if weight_quant == "none":
        decoder = cast_decode_tree(params["decoder"], dtype)
        mem_src = params      # the float32 weights, then cast (JAX's flow)
    else:
        decoder = quantize_decode_weights(params["decoder"], dtype,
                                          QUANT_BITS[weight_quant])
        mem_src = {"decoder": decoder}
    mem_kv = [(k.to(dtype), v.to(dtype)) for k, v in precompute_memory_kv(
        mem_src, memory.to(dtype), cfg.num_decoder_layers, cfg.nhead)]
    decode = {"decoder": fuse_self_qkv(decoder)}
    self_kv = kv_caches(cfg, b, seq_len, device)
    ts_emb = model._timestep(torch.arange(seq_len, device=device))
    embed_action = cast_decode_tree(params["embed_action"], dtype)
    # One (hidden, 5 + 6*1000) head product per step, in float32.
    heads = {k: torch.cat([params["predict_cmd"][k],
                           params["predict_params"][k]], dim=0)
             for k in ("weight", "bias")}

    act = torch.zeros((b, ACT_DIM), device=device)
    cmds, param_logits = [], []
    for t in range(seq_len):
        x = torch.tanh(_dense(embed_action, act.to(dtype)) + ts_emb[t])
        hidden, self_kv = decode_step(decode, cfg, x, t, self_kv, mem_kv,
                                      cfg.window_size, seq_len)
        logits = _dense(heads, hidden.to(torch.float32))
        cmd = logits[:, :cfg.num_classes]
        par = logits[:, cfg.num_classes:].reshape(
            b, cfg.num_params, cfg.num_params_values)
        act = next_actions(cmd, par) if action else torch.zeros_like(act)
        cmds.append(cmd)
        param_logits.append(par)
    return torch.stack(cmds, dim=1), torch.stack(param_logits, dim=1)
