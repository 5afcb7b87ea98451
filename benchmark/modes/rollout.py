"""Offline scoring of a checkpoint: ``infer/rollout.py:sequential_inference``
(``cli/evaluate.py --sequential``) back to back.

Parameters: ``batch`` rollouts a call of ``seq_len`` steps; ``inputs``
distinct input sets (frames and CAD images, made on the card from the
seed) used in turn; ``check_rollouts`` calls judged; ``control``
(``benchmark/control.py``).

One warm-up call in set-up; the window runs whole calls until
``--seconds`` have passed and ends with the call in flight then, in a
device synchronisation. A call's served tokens are its argmaxes: the
command's and each parameter's, every step. Afterwards the reference runs
the judged calls teacher-forced on the actions the rollout fed back (the
masked argmaxes): the first call of the window and others drawn from the
seed.

The rollout is VideoCADFormer's alone: it builds the port's model and the
reference itself and takes no family (``benchmark/families/``), since no
configuration of another family needs a rollout cell yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import synthetic
from benchmark.harness import Context
from benchmark.reference import model as ref_model
from benchmark.reference.decode import gap_stats, mask_params, token_gaps
from benchmark.trace import Tracer


def run(ctx: Context) -> dict:
    from videocad_tpu_torch.infer.rollout import sequential_inference
    from videocad_tpu_torch.models.videocadformer import (
        VideoCADFormer, VideoCADFormerConfig)

    p = ctx.params
    size = ctx.model_cfg.get("image_size", 224)
    cad_size = 256 if ctx.model_cfg.get("use_pretrained_cad_model") else size
    weights = ref_model.make_weights(ctx.model_cfg, ctx.seed, ctx.device)
    model = VideoCADFormer(VideoCADFormerConfig.from_json(ctx.model_cfg),
                           device=ctx.device)
    model.load_state_dict(weights, strict=True)
    model.eval()
    del weights
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    frames = synthetic.pixels(gen, (p["inputs"], p["batch"], p["seq_len"],
                                    size, size, 3), ctx.device)
    cads = synthetic.pixels(gen, (p["inputs"], p["batch"], cad_size,
                                  cad_size, 3), ctx.device)

    def call(i: int):
        cmd, par = sequential_inference(model, frames[i % p["inputs"]],
                                        cads[i % p["inputs"]])
        return cmd.argmax(dim=-1), par.argmax(dim=-1)

    ctx.mark("weights, model and inputs")
    call(0)
    ctx.mark("warm-up rollout")
    tracer = Tracer(ctx.trace, ctx.sync)
    t0 = ctx.open_window()
    tokens = []
    tracer.start()
    if ctx.trace:
        call(0)      # the tracer's warm-up, inside the window
        tokens.append(None)
        tracer.begin()
        tokens.append(call(1))
        tracer.stop(p["seq_len"])
        tracer.label(lambda: tokens.append(call(len(tokens))))
    while time.perf_counter() - t0 < ctx.seconds:
        tokens.append(call(len(tokens)))
    ctx.sync()
    window = time.perf_counter() - t0
    peak = ctx.memory_peak()
    del model
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    gaps = judge(ctx, p, frames, cads, tokens)
    actions = p["batch"] * p["seq_len"] * len(tokens)
    return {
        "attempted": len(tokens), "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"rollout_actions_per_s": actions / window},
        "data": {"window_s": window, "trace": tracer.summary()},
        "numbers": gaps,
    }


def judge(ctx: Context, p: dict, frames, cads, tokens) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done = [i for i, t in enumerate(tokens) if t is not None]
    rng = np.random.default_rng([ctx.seed, 6])
    rest = done[1:]
    picked = [done[0]] + [int(i) for i in rng.choice(
        rest, size=min(len(rest), p["check_rollouts"] - 1), replace=False)]
    weights = ref_model.make_weights(ctx.model_cfg, ctx.seed, ctx.device)
    control = ctx.params.get("control") == "fp8_reference"
    gaps = []
    for i in picked:
        cmd, par = tokens[i]
        masked = mask_params(cmd, par.clone())
        actions = torch.cat([cmd[..., None], masked], dim=-1)
        for row in range(p["batch"]):
            gaps.append(token_gaps(
                weights, ctx.model_cfg,
                frames[i % p["inputs"]][row:row + 1],
                cads[i % p["inputs"]][row:row + 1], actions[row:row + 1],
                param_tokens=par[row:row + 1], control=control))
    return gap_stats(torch.cat(gaps))
