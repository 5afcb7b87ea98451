"""Interpretability: CAD-image saliency and ViT attention rollout.

Port of ``videocad_tpu/infer/interpret.py``. Saliency is one autograd
gradient of the selected command logit with respect to the CAD image; the
attention rollout reads the softmax weights the CAD encoder returns under
``ViT.forward(..., return_attention=True)`` (JAX's ``sow_attention``).

Two departures from JAX, both where JAX cannot run at all: the GenCAD CAD
input (256 x 256 x 3 edge images) is normalized on its three channels, as
the model itself does, where JAX's grayscale conversion would hand its
3-channel encoder one channel; and the rollout's grid and default size are
the CAD encoder's own.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from videocad_tpu_torch.actions.ops import normalize_actions
from videocad_tpu_torch.models.vit import ViT
from videocad_tpu_torch.ops.preprocess import _resize_2d, maybe_preprocess


def _cad_input(model: nn.Module, cad_image) -> torch.Tensor:
    """The CAD image as the CAD encoder takes it, float32 on the model's
    device: grayscale in [-1, 1] (JAX's ``maybe_preprocess`` with its
    defaults), or under GenCAD the edge image normalized on all three
    channels; floats pass through."""
    cad = torch.as_tensor(cad_image, device=model.device)
    mode = ("normalize_only" if model.config.use_pretrained_cad_model
            else "grayscale")
    return maybe_preprocess(cad, mode=mode).to(torch.float32)


def cad_saliency(model: nn.Module, batch: Dict,
                 target_class: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|d logit / d cad_image|, max over channels -> (B, H, W) heatmaps.

    The first timestep's command logits (frames[:, :1], normalized
    actions[:, :1]); the logit of ``target_class``, or of each row's argmax.
    Returns (the preprocessed CAD image, the saliency). Runs with autograd
    on whatever the caller's grad mode, and leaves no gradient on the
    model's parameters.
    """
    device = model.device
    inputs = {
        "frames": torch.as_tensor(batch["frames"], device=device)[:, :1],
        "actions": normalize_actions(torch.as_tensor(
            batch["actions"], device=device))[:, :1],
    }
    if batch.get("multiview_images") is not None:
        # Views have no time axis: all of them, as JAX passes them.
        inputs["multiview_images"] = torch.as_tensor(
            batch["multiview_images"], device=device)
    cad = _cad_input(model, batch["cad_image"]).detach()
    with torch.enable_grad():
        cad.requires_grad_(True)
        cmd_logits, _ = model(dict(inputs, cad_image=cad))
        first = cmd_logits[:, 0]                         # (B, num_classes)
        if target_class is None:
            idx = first.argmax(dim=1)
        else:
            idx = torch.full((first.shape[0],), target_class, device=device)
        selected = first.gather(1, idx[:, None]).sum()
        (grads,) = torch.autograd.grad(selected, cad)
    return cad.detach(), grads.abs().amax(dim=-1)        # max over channels


@torch.no_grad()
def attention_rollout(model: nn.Module, cad_image,
                      discard_ratio: float = 0.0,
                      output_size: Optional[int] = None) -> torch.Tensor:
    """Attention rollout over the CAD ViT encoder -> (B, S, S) heatmaps.

    The joint attention is the product over layers of the row-normalized
    (head-mean attention + I); the CLS row's patch attention reshapes to
    the patch grid and is resized bilinearly to ``output_size`` (default:
    the encoder's image size) with the port's ``jax.image.resize``
    matrices. As in JAX, the encoder runs at float32 with the plain
    attention core: a float32 copy of the model's CAD encoder.
    """
    if model.config.encoder != "vit":
        raise ValueError("attention rollout requires the ViT encoder")
    encoder = model.cad_encoder
    vit = ViT(encoder.cfg, dtype=torch.float32, device=model.device)
    vit.load_state_dict(encoder.state_dict())
    _, attn = vit.eval()(_cad_input(model, cad_image),
                         return_attention=True)          # (L, B, H, N, N)
    attn = attn.mean(dim=2)                              # (L, B, N, N)

    if discard_ratio > 0:
        flat = attn.reshape(attn.shape[:2] + (-1,))
        k = int(flat.shape[-1] * discard_ratio)
        if k > 0:
            thresh = flat.sort(dim=-1).values[..., k:k + 1]
            attn = torch.where(flat < thresh, 0.0, flat).reshape(attn.shape)

    n = attn.shape[-1]
    attn = attn + torch.eye(n, device=attn.device)
    attn = attn / attn.sum(dim=-1, keepdim=True)
    joint = attn[0]
    for layer in attn[1:]:
        joint = torch.einsum("bij,bjk->bik", layer, joint)

    grid = encoder.cfg.image_size // encoder.cfg.patch_size
    mask = joint[:, 0, 1:].reshape(-1, grid, grid)       # CLS -> patches
    size = output_size or encoder.cfg.image_size
    return _resize_2d(mask, (size, size))
