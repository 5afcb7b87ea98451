#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videocad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an NVIDIA H100
(or another sm_90a card), the CUDA toolkit and PyTorch built for CUDA. It
imports nothing of JAX. Phases, each of which must pass:

  1. the card: its name and power limit (nvidia-smi), TF32 off;
  2. build of every kernel of the serving path from videocad_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the shapes the path
     gives it, with the tolerance stated, and both timed with CUDA events;
  4. serve: the flagship config at full width in bf16 with seeded random
     weights, through the serving CLI's build_engine, behind the HTTP
     server; three staggered sessions step through ServingClient, some
     steps concurrent;
  5. rollout: sequential_inference on the flagship at B=2, T=187;
  6. reference: the same path at the flagship's widths in float32, with the
     depth cut to 2 + 2 layers, on the card and on the CPU (plain
     versions), logits compared.

The kernels' launch counters are set to 0 just before phase 4 and read
after phase 5: each kernel must have been launched by the main path. The
second-to-last lines are a JSON object of the kernels and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}. Any
failure exits non-zero without that line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCHES_BF16 = (1, 8, 374, 1496)  # CAD encode, a tick, B*T at B=2 and 8
SEQ, HEADS, WIDTH = 50, 16, 1024  # the flagship ViT: 50 tokens, 16 x 64
LANES, SEQ_LEN = 8, 187
STEPS = 10                        # served steps per session


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, message: str) -> None:
    if not cond:
        fail(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``reps`` launches."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_f64(q, k, v):
    """The kernel's function in float64 (no rounding of the weights)."""
    import torch

    b, t, hd = q.shape
    d = hd // HEADS
    split = lambda x: x.double().reshape(b, t, HEADS, d).transpose(1, 2)  # noqa: E731
    weights = torch.softmax(split(q) @ split(k).transpose(-1, -2)
                            / math.sqrt(d), dim=-1)
    return (weights @ split(v)).transpose(1, 2).reshape(b, t, hd)


def phase_kernels(fa):
    """Phase 3: mhsa_short against its plain version; returns the rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, dtype, max_tol, mean_tol in (
            [(b, torch.bfloat16, 2e-2, 1e-3) for b in BATCHES_BF16]
            + [(8, torch.float32, 1e-5, 1e-5)]):
        q, k, v = (torch.randn((b, SEQ, WIDTH), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        with torch.no_grad():
            got = fa.mhsa_short(q, k, v, HEADS)
            torch.cuda.synchronize()
            want = fa.mhsa_short_reference(q, k, v, HEADS)
            err = (got.float() - want.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            # Against float64 too: the plain version sums in the same
            # order as the kernel, so their difference alone can be 0.
            f64_err = (got.double() - attention_f64(q, k, v)).abs().max()
            # Plain, kernel, kernel, plain: both timed in turns.
            kernel = lambda: fa.mhsa_short(q, k, v, HEADS)  # noqa: E731
            plain = lambda: fa.mhsa_short_reference(q, k, v, HEADS)  # noqa: E731
            p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel,
                                                   plain))
        row = {"batch": b, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": max_err, "mean_abs_err": mean_err,
               "max_abs_err_vs_f64": f64_err.item(),
               "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
        print(f"mhsa_short {row}", flush=True)
        check(math.isfinite(max_err) and max_err <= max_tol
              and mean_err <= mean_tol,
              f"mhsa_short B={b} {dtype}: max err {max_err} (tol {max_tol}),"
              f" mean err {mean_err} (tol {mean_tol})")
        rows.append(row)
    return rows


def valid_reply(reply, step: int) -> bool:
    params, action = reply.get("params"), reply.get("action")
    return (reply.get("step") == step and reply.get("cmd") in range(5)
            and isinstance(params, list) and len(params) == 6
            and all(-1 <= p <= 999 for p in params)
            and isinstance(action, list) and len(action) == 7
            and all(math.isfinite(a) for a in action))


def phase_serve(fa, np):
    """Phase 4: the flagship behind the HTTP server; returns the engine."""
    from videocad_tpu_torch.cli.serve import build_engine, parse_args
    from videocad_tpu_torch.infer.server import ServingClient, make_server
    from videocad_tpu_torch.models.factory import FLAGSHIP_NAME

    start = time.monotonic()
    engine = build_engine(parse_args([
        "--device", "cuda", "--lanes", str(LANES), "--seq_len", str(SEQ_LEN),
        "--model_config", str(REPO / "model_configs"
                              / "transformer_experiments.json"),
        "--model_name", FLAGSHIP_NAME]))
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"serve: flagship built on {engine.device} in "
          f"{time.monotonic() - start:.1f} s, {n_params} parameters, "
          f"dtype {engine.model.config.dtype}", flush=True)
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        rng = np.random.default_rng(0)
        cads = rng.integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
        frames = rng.integers(0, 256, (3, STEPS, 224, 224, 3),
                              dtype=np.uint8)
        replies = [[None] * STEPS for _ in range(3)]
        sids = []

        def step(i, s):
            replies[i][s] = client.step(sids[i], frames[i][s])

        def run(i, first):
            for s in range(first, STEPS):
                step(i, s)

        start = time.monotonic()
        sids.append(client.open_session(cads[0]))      # staggered opens
        step(0, 0)
        step(0, 1)
        sids.append(client.open_session(cads[1]))
        step(1, 0)
        step(0, 2)
        sids.append(client.open_session(cads[2]))
        workers = [threading.Thread(target=run, args=args)
                   for args in ((0, 3), (1, 1), (2, 0))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
            check(not w.is_alive(), "a serving client thread hung")
        seconds = time.monotonic() - start
        for i in range(3):
            for s in range(STEPS):
                check(replies[i][s] is not None
                      and valid_reply(replies[i][s], s),
                      f"session {i} step {s}: bad reply {replies[i][s]}")
        stats = client.stats()
        for sid in sids:
            client.close_session(sid)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    check(stats["ticks"] > 0 and stats["steps"] == 3 * STEPS,
          f"serve stats {stats}")
    print(f"serve: 3 sessions x {STEPS} steps in {seconds:.2f} s; "
          f"ticks {stats['ticks']}, coalescing {stats['coalescing_factor']}, "
          f"tick ms p50 {stats['p50_tick_ms']} p95 {stats['p95_tick_ms']} "
          f"mean {stats['mean_tick_ms']}; first replies "
          f"{[replies[i][0]['cmd'] for i in range(3)]}", flush=True)
    launches = fa.mhsa_short.launches
    check(launches > 0, "serving launched no mhsa_short kernel")
    print(f"serve: mhsa_short launches {launches}", flush=True)
    return engine


def phase_rollout(fa, engine):
    """Phase 5: the KV-cached rollout on the flagship at B=2, T=187."""
    import torch

    from videocad_tpu_torch.infer.rollout import sequential_inference

    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randint(0, 256, (2, SEQ_LEN, 224, 224, 3),
                           generator=gen, dtype=torch.uint8, device="cuda")
    cad = torch.randint(0, 256, (2, 224, 224, 3), generator=gen,
                        dtype=torch.uint8, device="cuda")
    before = fa.mhsa_short.launches
    torch.cuda.synchronize()
    start = time.monotonic()
    cmd, par = sequential_inference(engine.model, frames, cad)
    torch.cuda.synchronize()
    seconds = time.monotonic() - start
    check(tuple(cmd.shape) == (2, SEQ_LEN, 5)
          and tuple(par.shape) == (2, SEQ_LEN, 6, 1000),
          f"rollout shapes {tuple(cmd.shape)} {tuple(par.shape)}")
    check(bool(torch.isfinite(cmd).all()) and bool(torch.isfinite(par).all()),
          "rollout logits are not finite")
    launches = fa.mhsa_short.launches - before
    check(launches > 0, "the rollout launched no mhsa_short kernel")
    print(f"rollout: B=2 T={SEQ_LEN} in {seconds:.2f} s "
          f"({2 * SEQ_LEN / seconds:.1f} actions/s); mhsa_short launches "
          f"{launches}", flush=True)
    return seconds


def phase_reference():
    """Phase 6: the path at the flagship's widths in float32 (depth cut to
    2 + 2), on the card and on the CPU, logits compared."""
    import torch

    from videocad_tpu_torch.infer.rollout import sequential_inference
    from videocad_tpu_torch.models.factory import create_model, flagship_config

    cfg = dict(flagship_config(), dtype="float32", vit_depth=2,
               num_decoder_layers=2)
    rng = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (1, 6, 224, 224, 3), generator=rng,
                           dtype=torch.uint8)
    cad = torch.randint(0, 256, (1, 224, 224, 3), generator=rng,
                        dtype=torch.uint8)
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(3))
        outs[device] = [x.cpu() for x in sequential_inference(
            model, frames, cad)]
    errs = [(g - w).abs().max().item()
            for g, w in zip(outs["cuda"], outs["cpu"])]
    check(all(e <= 1e-3 for e in errs),
          f"float32 rollout on the card differs from the CPU: {errs}")
    print(f"reference: float32 rollout (depth 2+2, T=6), card vs CPU max "
          f"abs err cmd {errs[0]:.3g} params {errs[1]:.3g} (tol 1e-3)",
          flush=True)


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check((REPO / "videocad_tpu_torch").is_dir(),
          f"no videocad_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from videocad_tpu_torch.kernels import build
    from videocad_tpu_torch.ops import fused_attention as fa

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.monotonic()
    fa.load_library()
    seconds, log = build.build_log.get("mhsa_short", (0.0, "(cached)"))
    print(f"build: mhsa_short in {time.monotonic() - start:.1f} s "
          f"(nvcc {seconds:.1f} s)\n{log.strip()}", flush=True)

    rows = phase_kernels(fa)

    fa.mhsa_short.launches = 0            # the main path starts here
    engine = phase_serve(fa, np)
    phase_rollout(fa, engine)
    launches = fa.mhsa_short.launches    # the main path ends here
    del engine
    torch.cuda.empty_cache()

    phase_reference()

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    tick = next(r for r in bf16 if r["batch"] == LANES)
    print(json.dumps({"kernels": [{
        "name": "mhsa_short", "route": "cuda",
        "source": "videocad_tpu_torch/csrc/mhsa_short.cu",
        "replaces": "videocad_tpu/ops/fused_attention.py:110",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tick["ms"], "plain_ms": tick["plain_ms"],
        "checks": rows}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
