"""Training from disk: the chain ``Trainer._train_epoch`` runs, driven in
the window: ``data/pipeline.py:DataPipeline.epoch`` over
``data/dataset.py:VideoCADDataset`` (the port's defaults: two assembly
threads, shuffled, the default buckets) -> ``device_prefetch(size=2)`` ->
the train step of the configuration's family (``benchmark/families/``).

Parameters: ``batch``; the store (``benchmark/store.py``): ``sequences``,
``aliases``, ``min_len``, ``max_len``; ``buckets`` (the loader's); ``lr``;
``warmup_steps``; ``trace_seconds``.

Set-up writes the store under ``TMPDIR`` and drives the first three steps
and the warm-up through the same iterator the window then continues (the
next epoch follows if one ends). ``loader_wait_ms.train`` is the
benchmark's own timer around each ``next()`` of the device-prefetch
iterator, in the untraced part of the window.
After the window the reference reads the three checked batches' sequences
from the store itself and compares them with what the data layer
delivered, trains its three steps on its own reading, and checks every
batch of the window by its rows' sums against the store's.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import store, training
from benchmark.harness import Context, load_module
from benchmark.trace import Tracer


def _bucket(length: int, buckets) -> int:
    return next(b for b in buckets if length <= b)


def run(ctx: Context) -> dict:
    root = tempfile.mkdtemp(prefix="vc-bench-store-",
                            dir=os.environ.get("TMPDIR"))
    try:
        return _run(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx: Context, root: str) -> dict:
    from videocad_tpu_torch.data.dataset import VideoCADDataset
    from videocad_tpu_torch.data.pipeline import DataPipeline, device_prefetch

    p = ctx.params
    size = ctx.model_cfg.get("image_size", 224)
    owner = store.write(root, p, ctx.seed, size)
    ctx.mark("store written")
    fam = load_module("families", ctx.family)
    weights = fam.make_weights(ctx)
    model, state, step = fam.build_program(ctx, weights)
    ctx.mark("weights, model and optimizer")
    readings = training.ProgramReadings(weights)
    pipe = DataPipeline(VideoCADDataset(root, image_size=size,
                                        enable_random=True),
                        batch_size=p["batch"], buckets=tuple(p["buckets"]))
    ids, sums = [], []

    def host_batches():
        epoch = 0
        while True:
            for batch in pipe.epoch(epoch):
                ids.append(list(batch["ids"]))
                yield {k: v for k, v in batch.items()
                       if isinstance(v, np.ndarray)}
            epoch += 1

    feed = device_prefetch(host_batches(), ctx.device, size=2)
    checked, waits = [], []
    done = 0

    def one_step(record_wait: bool = False):
        nonlocal state, done
        start = time.perf_counter()
        batch = next(feed)
        if record_wait:
            waits.append(time.perf_counter() - start)
        rows = batch["frames"].shape[0]
        sums.append((batch["frames"].view(rows, -1).sum(1),
                     batch["actions"].view(rows, -1).sum(1)))
        state, loss, _ = step(state, batch, ctx.seed)
        done += 1
        return batch, loss

    for _ in range(3):
        batch, loss = one_step()
        checked.append(batch)
        readings.after_step(state, loss, weights)
    ctx.mark("three checked steps")
    for _ in range(p["warmup_steps"]):
        one_step()
    ctx.mark("warm-up steps")

    tracer = Tracer(ctx.trace, ctx.sync)
    start_done = done
    t0 = ctx.open_window()
    rate_from = (t0, done)
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
        one_step(record_wait=True)
    ctx.sync()
    t_end = time.perf_counter()
    peak = ctx.memory_peak()
    window = t_end - t0
    del model, state, step, feed
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    sequences = {i: store.read(root, i) for i in set(owner.values())}
    lengths = {i: len(s["actions"]) for i, s in sequences.items()}
    # What the window trained on: the real frames of each batch it took.
    frames = sum(lengths[owner[i]] - 1 for row in ids[start_done:done]
                 for i in row)
    rate_frames = sum(lengths[owner[i]] - 1
                      for row in ids[rate_from[1]:done] for i in row)
    numbers = check_batches(ctx, root, owner, ids, sums, checked, sequences)
    reference = [{k: torch.from_numpy(v).to(ctx.device) for k, v in
                  store.batch(root, [owner[i] for i in ids[k]],
                              _bucket(max(lengths[owner[i]] for i in ids[k]),
                                      p["buckets"])).items()}
                 for k in range(3)]
    for b in reference:
        b["actions"] = b["actions"].float()
    numbers.update(training.compare(ctx, fam, readings, reference, weights))
    bucket = _bucket(p["max_len"], p["buckets"])
    return {
        "attempted": done - start_done, "failed": 0,
        "memory_peak_bytes": peak,
        "e2e": {"train_frames_per_s": frames / window,
                "train_peak_gb": peak / 1e9},
        "data": {"window_s": window, "steps": done - start_done,
                 "rate_window_s": t_end - rate_from[0],
                 "rate_steps": done - rate_from[1],
                 "rate_frames": rate_frames,
                 "loader_wait_s": waits,
                 **training.step_work(fam, ctx.model_cfg, p["batch"],
                                      bucket - 1),
                 "trace": tracer.summary()},
        "numbers": numbers,
    }


def check_batches(ctx, root, owner, ids, sums, checked, sequences) -> dict:
    """Elements of the three checked batches that differ from the store,
    and rows of every batch whose frame or action sums differ from it."""
    p = ctx.params
    lengths = {i: len(s["actions"]) for i, s in sequences.items()}
    wrong = 0
    for k, got in enumerate(checked):
        rows = [owner[i] for i in ids[k]]
        want = store.batch(root, rows, _bucket(
            max(lengths[r] for r in rows), p["buckets"]))
        for key in ("frames", "cad_image"):
            wrong += int((got[key].cpu().numpy() != want[key]).sum())
        wrong += int((got["actions"].cpu().numpy().astype(np.int64)
                      != want["actions"]).sum())
    expected = {i: (int(s["frames"].astype(np.int64).sum()),
                    int(s["actions"].sum())) for i, s in sequences.items()}
    bad_rows = 0
    for row_ids, (frame_sums, action_sums) in zip(ids, sums):
        bucket = _bucket(max(lengths[owner[j]] for j in row_ids),
                         p["buckets"])
        got = zip(frame_sums.cpu().tolist(), action_sums.cpu().tolist())
        for i, (f, a) in zip(row_ids, got):
            want_f, want_a = expected[owner[i]]
            want_a -= 7 * (bucket - lengths[owner[i]])   # -1 padding
            bad_rows += int(f != want_f or round(a) != want_a)
    return {"batch_elements_wrong": wrong, "window_rows_wrong": bad_rows}
