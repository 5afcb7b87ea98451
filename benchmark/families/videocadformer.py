"""VideoCADFormer (``models/videocadformer.py``), the model of every named
configuration of the repository, as the training modes take it.

A family file gives the training modes (``benchmark/modes/train.py``,
``train_disk.py``) what depends on the model; a configuration names its
family under ``family`` (absent: this one). Every family gives:

  build_program(ctx, weights)   the port's model with ``weights`` loaded,
                                its train state and its train step
  make_weights(ctx)             the weights of ``ctx.seed``, made on
                                ``ctx.device``, keyed by the program's
                                parameter names
  reference_trainer(ctx, weights, low_precision)
                                the plain reference's trainer: ``step(batch,
                                seed)`` -> (loss, each leaf's clipped
                                gradient norm), ``params``; in fp8 with
                                ``low_precision`` (the control)
  train_step_flops(cfg, batch, t)   model FLOPs of one train step
  k1_calls(cfg, batch, t)       (frames, tokens, heads, head_dim, backward)
                                of every K1 call of a step; [] for a
                                family without the ViT

This file is the only one of the training cells that imports the port's
model; the reference it names imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import flops
from benchmark.reference import model as ref_model
from benchmark.reference.train import Trainer


def build_program(ctx, weights: Dict[str, torch.Tensor]):
    """The port's model with ``weights`` loaded, its train state and step."""
    from videocad_tpu_torch.models.videocadformer import (
        VideoCADFormer, VideoCADFormerConfig)
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state,
                                          make_train_step)

    model = VideoCADFormer(VideoCADFormerConfig.from_json(ctx.model_cfg),
                           device=ctx.device)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(dict(model.named_parameters()),
                               {"lr": ctx.params["lr"]})
    step = make_train_step(model, LossConfig(REFERENCE_CMD_WEIGHTS),
                           noise=False)
    return model, state, step


def make_weights(ctx) -> Dict[str, torch.Tensor]:
    return ref_model.make_weights(ctx.model_cfg, ctx.seed, ctx.device)


def reference_trainer(ctx, weights: Dict[str, torch.Tensor],
                      low_precision: bool = False) -> Trainer:
    return Trainer(ctx.model_cfg, weights, ctx.params["lr"], low_precision)


def train_step_flops(cfg: Dict, batch: int, t: int) -> int:
    return flops.train_step_flops(cfg, batch, t)


def k1_calls(cfg: Dict, batch: int, t: int
             ) -> List[Tuple[int, int, int, int, bool]]:
    """Every K1 call of one train step: each ViT block of the state
    encoder (B * T frames) and of the CAD encoder (B images), forward and
    backward."""
    s = ref_model.sizes(cfg)
    tokens = (s["image"] // s["patch"]) ** 2 + 1
    cad_tokens = (256 // s["patch"]) ** 2 + 1 if s["gencad"] else tokens
    calls = []
    for frames, n in ((batch * t, tokens), (batch, cad_tokens)):
        for _ in range(s["vit_depth"]):
            calls += [(frames, n, s["vit_heads"], s["vit_head_dim"], False),
                      (frames, n, s["vit_heads"], s["vit_head_dim"], True)]
    return calls
