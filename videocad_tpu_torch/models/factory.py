"""Model factory: named JSON configs -> model with seeded parameters.

Port of ``videocad_tpu/models/factory.py``. Every named config builds a
VideoCADFormer whatever its ``model_name`` (the reference factory's
behaviour), except ``model_family: "decision_transformer"``, which builds
the decision transformer (``models/decision_transformer.py``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from videocad_tpu_torch.models.decision_transformer import \
    DecisionTransformer
from videocad_tpu_torch.models.layers import Dense
from videocad_tpu_torch.models.resnet import Conv
from videocad_tpu_torch.models.videocadformer import (GENCAD_IMAGE_SHAPE,
                                                      VideoCADFormer,
                                                      VideoCADFormerConfig)
from videocad_tpu_torch.models.vit import ViT

# The flagship experiment of model_configs/transformer_experiments.json.
FLAGSHIP_NAME = "cad_past_10_actions_and_states_timestep_embedding"
_CONFIG_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "model_configs"))


def load_named_config(config_path: str, name: str) -> Dict[str, Any]:
    with open(config_path) as f:
        configs = json.load(f)
    if name not in configs:
        raise KeyError(f"Config '{name}' not in {config_path}; "
                       f"available: {sorted(configs)}")
    return configs[name]


def flagship_config() -> Dict[str, Any]:
    """The flagship named config, loaded from the repo's config file."""
    return load_named_config(
        os.path.join(_CONFIG_DIR, "transformer_experiments.json"),
        FLAGSHIP_NAME)


# flax's lecun_normal: a normal truncated to two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _fill(param: torch.Tensor, sample, generator: torch.Generator) -> None:
    """Draw on the generator's device (CPU), copy to the parameter's."""
    tmp = torch.empty(param.shape, dtype=torch.float32)
    sample(tmp, generator)
    with torch.no_grad():
        param.copy_(tmp)


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter with flax's initializer families, drawn
    from ``generator`` (a CPU ``torch.Generator``) in module order:

      * Dense and convolution kernels: lecun normal (a convolution's fan
        in is in_channels * kh * kw); biases: zeros;
      * LayerNorm, GroupNorm: ones / zeros;
      * cls token and position embedding: N(0, 0.02);
      * Embedding: N(0, 1 / features) (flax ``nn.Embed``'s default).

    The numbers differ from flax's for the same seed (another generator);
    the distributions are the same.
    """
    for module in model.modules():
        if isinstance(module, (Dense, Conv)):
            fan_in = math.prod(module.weight.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            _fill(module.weight, lambda t, g, s=std: nn.init.trunc_normal_(
                t, 0.0, s, -2 * s, 2 * s, generator=g), generator)
            if getattr(module, "bias", None) is not None:
                with torch.no_grad():
                    module.bias.zero_()
        elif isinstance(module, ViT):
            for p in (module.cls_token, module.pos_embedding):
                _fill(p, lambda t, g: nn.init.normal_(t, 0.0, 0.02,
                                                      generator=g), generator)
        elif isinstance(module, nn.Embedding):
            std = math.sqrt(1.0 / module.weight.shape[1])
            _fill(module.weight, lambda t, g, s=std: nn.init.normal_(
                t, 0.0, s, generator=g), generator)
    # LayerNorm and GroupNorm parameters are constructed as ones / zeros
    # already.
    return model


def create_model(model_config: Dict[str, Any], device="cpu",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the model on ``device`` from a config dict (the reference JSON
    schema), with parameters from :func:`init_params` (seed 0 when no
    ``generator`` is given), in eval mode: a VideoCADFormer, or with
    ``model_family: "decision_transformer"`` a DecisionTransformer
    (``n_layer``, ``n_head``, ``enable_image_conditioning`` from the
    config, defaults 6, 8, true)."""
    cfg = VideoCADFormerConfig.from_json(model_config)
    device = torch.device(device)
    if model_config.get("model_family") == "decision_transformer":
        model = DecisionTransformer(
            cfg, n_layer=model_config.get("n_layer", 6),
            n_head=model_config.get("n_head", 8),
            enable_image_conditioning=model_config.get(
                "enable_image_conditioning", True), device=device)
    else:
        model = VideoCADFormer(cfg, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_params(model, generator)
    return model.eval()


def example_inputs(cfg: VideoCADFormerConfig, batch: int = 1,
                   seq_len: int = 4, device="cpu") -> Dict[str, torch.Tensor]:
    """A zero batch with the model's input contract (NHWC frames; the
    256 x 256 x 3 CAD edge image under GenCAD; ``multiview_images`` for a
    model with views)."""
    h = w = cfg.image_size
    c = cfg.image_channels
    cad = GENCAD_IMAGE_SHAPE if cfg.use_pretrained_cad_model else (h, w, c)
    inputs = {
        "frames": torch.zeros((batch, seq_len, h, w, c), device=device),
        "actions": torch.zeros((batch, seq_len, cfg.act_dim), device=device),
        "cad_image": torch.zeros((batch,) + cad, device=device),
        "timesteps": torch.arange(seq_len, device=device)[None].expand(
            batch, seq_len),
    }
    if cfg.num_views > 0:
        inputs["multiview_images"] = torch.zeros(
            (batch, cfg.num_views, h, w, c), device=device)
    return inputs
