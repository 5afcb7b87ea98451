"""Training from batches resident on the card: the program's train step
(``train/steps.py:make_train_step``) driven back to back.

Parameters: ``batch`` rows of ``seq_len`` positions (the bucket), all real;
``batches`` distinct uint8 batches made on the card from the seed and used
in turn; ``lr``; ``warmup_steps`` after the three checked steps;
``trace_seconds`` of the window under the tracer.

The model is the configuration's family's (``benchmark/families/``).
Set-up builds the model, its Adam state and the step once and drives them
through the first three steps (on three different batches) and the
warm-up; the window then runs the same step on the same object until
``--seconds`` have passed and ends in a device synchronisation. The
reference follows the first three steps after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import synthetic, training
from benchmark.harness import Context, load_module
from benchmark.trace import Tracer


def make_batches(ctx: Context):
    p = ctx.params
    b, t, size = p["batch"], p["seq_len"], ctx.model_cfg.get("image_size",
                                                              224)
    rng = np.random.default_rng(ctx.seed)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    frames = synthetic.pixels(gen, (p["batches"], b, t, size, size, 3),
                              ctx.device)
    cads = synthetic.pixels(gen, (p["batches"], b, size, size, 3), ctx.device)
    batches, real = [], []
    for i in range(p["batches"]):
        actions = synthetic.padded_actions(rng, [t] * b, t)
        real.append(synthetic.real_frames(actions))
        batches.append({"frames": frames[i], "cad_image": cads[i],
                        "actions": torch.from_numpy(actions).float()
                        .to(ctx.device)})
    return batches, real


def run(ctx: Context) -> dict:
    p = ctx.params
    fam = load_module("families", ctx.family)
    weights = fam.make_weights(ctx)
    batches, real = make_batches(ctx)
    ctx.mark("weights and batches")
    model, state, step = fam.build_program(ctx, weights)
    readings = training.ProgramReadings(weights)
    ctx.mark("model and optimizer")
    n = len(batches)
    done = 0
    for _ in range(3):
        state, loss, _ = step(state, batches[done % n], ctx.seed)
        done += 1
        readings.after_step(state, loss, weights)
    ctx.mark("three checked steps")
    for _ in range(p["warmup_steps"]):
        state, _, _ = step(state, batches[done % n], ctx.seed)
        done += 1
    ctx.mark("warm-up steps")

    def one_step():
        nonlocal state, done, frames
        state, _, _ = step(state, batches[done % n], ctx.seed)
        frames += real[done % n]
        done += 1

    tracer = Tracer(ctx.trace, ctx.sync)
    frames = 0
    start_done = done
    t0 = ctx.open_window()
    rate_from = (t0, done)       # the rates' span: after the tracer
    tracer.start()
    if ctx.trace:
        one_step()
        tracer.begin()
        first = done
        while time.perf_counter() - t0 < p["trace_seconds"]:
            one_step()
        tracer.stop(done - first)
        tracer.label(one_step)
        rate_from = (time.perf_counter(), done)
    while time.perf_counter() - t0 < ctx.seconds:
        one_step()
    ctx.sync()
    t_end = time.perf_counter()
    window = t_end - t0
    steps = done - start_done
    peak = ctx.memory_peak()

    del model, state, step
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = training.compare(ctx, fam, readings, batches, weights)
    seq = p["seq_len"] - 1
    return {
        "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"train_frames_per_s": frames / window,
                "train_peak_gb": peak / 1e9},
        "data": {"window_s": window, "steps": steps,
                 "rate_window_s": t_end - rate_from[0],
                 "rate_steps": done - rate_from[1],
                 **training.step_work(fam, ctx.model_cfg, p["batch"], seq),
                 "trace": tracer.summary()},
        "numbers": numbers,
    }
