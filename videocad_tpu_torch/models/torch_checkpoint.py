"""Reference torch checkpoint -> the JAX parameter tree, numpy only.

A copy of the numpy part of ``tools/convert_torch_checkpoint.py``
(``strip_prefixes`` through ``convert_state_dict``), which the port cannot
import (``tools/`` is not part of it); a test holds the copy equal to the
original, array for array. It maps the reference AutoRegressiveTransformer
``state_dict`` (vit_pytorch encoders and ``nn.TransformerDecoder`` names,
with the ``module.`` / ``module._orig_mod.`` prefixes of DDP and compile,
and both vit_pytorch naming generations) onto the JAX parameter tree;
``models/convert.py:state_dict_from_jax`` then takes it into the port.
:func:`reference_state_dict` is its inverse, for a model with ViT
encoders: the reference names of a tree's weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(tensor):
    return np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
                      else tensor, dtype=np.float32)


def strip_prefixes(state_dict: Dict) -> Dict:
    out = {}
    for key, value in state_dict.items():
        for prefix in ("module._orig_mod.", "module."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[key] = value
    return out


def linear(sd: Dict, name: str) -> Dict:
    """torch Linear (out, in) -> flax Dense {kernel (in, out), bias}."""
    entry = {"kernel": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        entry["bias"] = _np(sd[f"{name}.bias"])
    return entry


def layernorm(sd: Dict, name: str) -> Dict:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def convert_mha(sd: Dict, name: str) -> Dict:
    """torch nn.MultiheadAttention (packed in_proj) -> {query,key,value,out}."""
    w = _np(sd[f"{name}.in_proj_weight"])  # (3h, h)
    b = _np(sd[f"{name}.in_proj_bias"])
    h = w.shape[0] // 3
    def head(i):
        return {"kernel": w[i * h:(i + 1) * h].T, "bias": b[i * h:(i + 1) * h]}
    return {
        "query": head(0), "key": head(1), "value": head(2),
        "out": linear(sd, f"{name}.out_proj"),
    }


def convert_decoder(sd: Dict, num_layers: int, prefix="transformer_decoder"
                    ) -> Dict:
    layers = {}
    for i in range(num_layers):
        p = f"{prefix}.layers.{i}" if prefix else f"layers.{i}"
        layers[f"layers_{i}"] = {
            "self_attn": convert_mha(sd, f"{p}.self_attn"),
            "cross_attn": convert_mha(sd, f"{p}.multihead_attn"),
            "linear1": linear(sd, f"{p}.linear1"),
            "linear2": linear(sd, f"{p}.linear2"),
            "norm1": layernorm(sd, f"{p}.norm1"),
            "norm2": layernorm(sd, f"{p}.norm2"),
            "norm3": layernorm(sd, f"{p}.norm3"),
        }
    return layers


def detect_config_overrides(state_dict: Dict) -> Dict:
    """Model-config overrides implied by the checkpoint's vit_pytorch
    generation. Merge into the model config BEFORE create_model so the
    module structure matches the converted params."""
    sd = strip_prefixes(state_dict)
    prefix = ("state_embedding_model"
              if any(k.startswith("state_embedding_model.") for k in sd)
              else "cad_embedding_model")
    overrides = {}
    if f"{prefix}.to_patch_embedding.1.weight" in sd and \
            f"{prefix}.to_patch_embedding.2.weight" not in sd:
        overrides["vit_patch_norm"] = False
    if f"{prefix}.transformer.norm.weight" not in sd and \
            any(k.startswith(f"{prefix}.transformer.") for k in sd):
        overrides["vit_final_norm"] = False
    return overrides


def convert_vit(sd: Dict, prefix: str, depth: int) -> Dict:
    """vit_pytorch ViT -> the JAX ViT's parameters (``models/vit.py``).

    Supports both naming generations (the reference pins no version,
    requirements.txt:vit-pytorch):
      * modern (>= the LN-patch-embed refactor): to_patch_embedding =
        Rearrange/LN/Linear/LN; Attention and FeedForward own their norms
        (layers.i.0.norm, layers.i.1.net.0 is a LayerNorm); a final
        transformer.norm exists.
      * legacy (PreNorm era): to_patch_embedding = Rearrange/Linear (no
        LNs); blocks are PreNorm-wrapped (layers.i.0.fn.to_qkv, norm at
        layers.i.0.norm; FF at layers.i.1.fn.net.0 / net.3); the final
        LayerNorm lived in mlp_head, which the reference replaces with
        Identity (trajectory_model.py:66) — so there is none. Build the
        module with detect_config_overrides(state_dict) merged into the
        model config (vit_patch_norm / vit_final_norm False).
    """
    def has(key):
        return f"{prefix}.{key}" in sd

    modern_patch = has("to_patch_embedding.2.weight")
    if modern_patch:
        params = {
            "patch_norm_in": layernorm(sd, f"{prefix}.to_patch_embedding.1"),
            "patch_embed": linear(sd, f"{prefix}.to_patch_embedding.2"),
            "patch_norm_out": layernorm(sd, f"{prefix}.to_patch_embedding.3"),
        }
    else:
        # Legacy patch embedding is Rearrange/Linear only — the module must
        # be built with vit_patch_norm=False (detect_config_overrides).
        params = {"patch_embed": linear(sd, f"{prefix}.to_patch_embedding.1")}
    params["pos_embedding"] = _np(sd[f"{prefix}.pos_embedding"])
    params["cls_token"] = _np(sd[f"{prefix}.cls_token"])

    for i in range(depth):
        attn = f"transformer.layers.{i}.0"
        ff = f"transformer.layers.{i}.1"
        legacy = has(f"{attn}.fn.to_qkv.weight")
        a = f"{attn}.fn" if legacy else attn

        qkv = _np(sd[f"{prefix}.{a}.to_qkv.weight"])  # (3*inner, dim)
        inner = qkv.shape[0] // 3
        block = {
            # PreNorm's norm and the modern in-module norm share the
            # "layers.i.0.norm" key
            "attn_norm": layernorm(sd, f"{prefix}.{attn}.norm"),
            "attn": {
                "query": {"kernel": qkv[:inner].T},
                "key": {"kernel": qkv[inner:2 * inner].T},
                "value": {"kernel": qkv[2 * inner:].T},
                "out": linear(sd, f"{prefix}.{a}.to_out.0"),
            },
        }
        if legacy:
            # legacy FeedForward.net = [Linear, GELU, Dropout, Linear, Drop]
            block["mlp_norm"] = layernorm(sd, f"{prefix}.{ff}.norm")
            block["mlp_in"] = linear(sd, f"{prefix}.{ff}.fn.net.0")
            block["mlp_out"] = linear(sd, f"{prefix}.{ff}.fn.net.3")
        else:
            # modern FeedForward.net = [LN, Linear, GELU, Drop, Linear, Drop]
            block["mlp_norm"] = layernorm(sd, f"{prefix}.{ff}.net.0")
            block["mlp_in"] = linear(sd, f"{prefix}.{ff}.net.1")
            block["mlp_out"] = linear(sd, f"{prefix}.{ff}.net.4")
        params[f"block_{i}"] = block

    if has("transformer.norm.weight"):
        params["final_norm"] = layernorm(sd, f"{prefix}.transformer.norm")
    # else: legacy — no final norm (vit_final_norm=False structurally)
    return params


def convert_state_dict(state_dict: Dict, model_config: Dict) -> Dict:
    """Full reference AutoRegressiveTransformer -> VideoCADFormer params."""
    sd = strip_prefixes(state_dict)
    num_layers = model_config.get("num_decoder_layers", 8)
    vit_depth = model_config.get("vit_depth", 6)

    params: Dict = {
        "decoder": convert_decoder(sd, num_layers),
        "embed_state": linear(sd, "embed_state"),
        "embed_image": linear(sd, "embed_image"),
        "embed_action": linear(sd, "embed_action"),
        "predict_cmd": linear(sd, "predict_action_class_0_4"),
        "predict_params": linear(sd, "predict_action_class_0_999"),
    }
    if "image_projection.weight" in sd:
        params["image_projection"] = linear(sd, "image_projection")
    if "embed_multiview.weight" in sd:
        params["embed_multiview"] = linear(sd, "embed_multiview")
    if "timestep_embedding.weight" in sd:
        params["timestep_embedding"] = {
            "embedding": _np(sd["timestep_embedding.weight"])}
    if model_config.get("encoder", "vit") == "vit":
        if any(k.startswith("state_embedding_model.") for k in sd):
            params["state_encoder"] = convert_vit(
                sd, "state_embedding_model", vit_depth)
        params["cad_encoder"] = convert_vit(sd, "cad_embedding_model",
                                            vit_depth)
    else:
        raise NotImplementedError(
            "resnet checkpoint conversion not implemented yet")
    return params


def _torch_linear(entry: Dict, name: str) -> Dict:
    out = {f"{name}.weight": np.asarray(entry["kernel"], np.float32).T}
    if "bias" in entry:
        out[f"{name}.bias"] = np.asarray(entry["bias"], np.float32)
    return out


def _torch_layernorm(entry: Dict, name: str) -> Dict:
    return {f"{name}.weight": np.asarray(entry["scale"], np.float32),
            f"{name}.bias": np.asarray(entry["bias"], np.float32)}


def _torch_mha(entry: Dict, name: str) -> Dict:
    heads = [entry[k] for k in ("query", "key", "value")]
    out = {f"{name}.in_proj_weight": np.concatenate(
               [np.asarray(h["kernel"], np.float32).T for h in heads]),
           f"{name}.in_proj_bias": np.concatenate(
               [np.asarray(h["bias"], np.float32) for h in heads])}
    out.update(_torch_linear(entry["out"], f"{name}.out_proj"))
    return out


def _torch_vit(tree: Dict, prefix: str) -> Dict:
    """The inverse of :func:`convert_vit`: a modern vit_pytorch layout,
    or the legacy one where the tree has no patch-embedding norms."""
    legacy = "patch_norm_in" not in tree
    out = {f"{prefix}.pos_embedding": np.asarray(tree["pos_embedding"]),
           f"{prefix}.cls_token": np.asarray(tree["cls_token"])}
    if legacy:
        out.update(_torch_linear(tree["patch_embed"],
                                 f"{prefix}.to_patch_embedding.1"))
    else:
        out.update(_torch_layernorm(tree["patch_norm_in"],
                                    f"{prefix}.to_patch_embedding.1"))
        out.update(_torch_linear(tree["patch_embed"],
                                 f"{prefix}.to_patch_embedding.2"))
        out.update(_torch_layernorm(tree["patch_norm_out"],
                                    f"{prefix}.to_patch_embedding.3"))
    depth = sum(1 for k in tree if k.startswith("block_"))
    for i in range(depth):
        block = tree[f"block_{i}"]
        attn = f"{prefix}.transformer.layers.{i}.0"
        ff = f"{prefix}.transformer.layers.{i}.1"
        inner = f"{attn}.fn" if legacy else attn
        out[f"{inner}.to_qkv.weight"] = np.concatenate(
            [np.asarray(block["attn"][k]["kernel"], np.float32).T
             for k in ("query", "key", "value")])
        out.update(_torch_linear(block["attn"]["out"], f"{inner}.to_out.0"))
        out.update(_torch_layernorm(block["attn_norm"], f"{attn}.norm"))
        if legacy:
            out.update(_torch_layernorm(block["mlp_norm"], f"{ff}.norm"))
            out.update(_torch_linear(block["mlp_in"], f"{ff}.fn.net.0"))
            out.update(_torch_linear(block["mlp_out"], f"{ff}.fn.net.3"))
        else:
            out.update(_torch_layernorm(block["mlp_norm"], f"{ff}.net.0"))
            out.update(_torch_linear(block["mlp_in"], f"{ff}.net.1"))
            out.update(_torch_linear(block["mlp_out"], f"{ff}.net.4"))
    if "final_norm" in tree:
        out.update(_torch_layernorm(tree["final_norm"],
                                    f"{prefix}.transformer.norm"))
    return out


def reference_state_dict(tree: Dict) -> Dict:
    """The inverse of :func:`convert_state_dict` (numpy arrays under the
    reference model's names) for a VideoCADFormer tree with ViT encoders:
    the layout a released checkpoint of that model has, in the vit_pytorch
    generation the tree's encoders were built for."""
    out: Dict = {}
    for name, layer in tree["decoder"].items():
        p = f"transformer_decoder.layers.{name.split('_')[1]}"
        out.update(_torch_mha(layer["self_attn"], f"{p}.self_attn"))
        out.update(_torch_mha(layer["cross_attn"], f"{p}.multihead_attn"))
        for key in ("linear1", "linear2"):
            out.update(_torch_linear(layer[key], f"{p}.{key}"))
        for key in ("norm1", "norm2", "norm3"):
            out.update(_torch_layernorm(layer[key], f"{p}.{key}"))
    for ours, theirs in (("embed_state", "embed_state"),
                         ("embed_image", "embed_image"),
                         ("embed_action", "embed_action"),
                         ("predict_cmd", "predict_action_class_0_4"),
                         ("predict_params", "predict_action_class_0_999"),
                         ("image_projection", "image_projection"),
                         ("embed_multiview", "embed_multiview")):
        if ours in tree:
            out.update(_torch_linear(tree[ours], theirs))
    if "timestep_embedding" in tree:
        out["timestep_embedding.weight"] = np.asarray(
            tree["timestep_embedding"]["embedding"], np.float32)
    if "state_encoder" in tree:
        out.update(_torch_vit(tree["state_encoder"],
                              "state_embedding_model"))
    out.update(_torch_vit(tree["cad_encoder"], "cad_embedding_model"))
    return out
