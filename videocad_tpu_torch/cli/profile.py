"""Profile the serving and training paths on a CUDA card: where each
piece's time goes.

    python -m videocad_tpu_torch.cli.profile [--device cuda]

Builds the flagship config at full width in bf16 (random weights from seed
0) and measures each piece of work of the serving path: one served tick
with all 8 lanes active (no HTTP), the CAD encode of ``open_lane``, the
state encoder over the rollout's B*T frames, the rollout at B=2, T=187,
and the ``mhsa_short`` kernel alone at the batches the path gives it; then
the training path: the flagship's train step (dropout 0.1) at B=8, T=192
and its eval step, as the JSON has the config, once more with ``ln_impl``
and ``dropout_impl`` ``"pallas"`` (the LayerNorm and dropout kernels), and
a third time with ``attention_impl`` ``"pallas"`` as well (the decoder's
flash attention kernels), and a fourth with ``vit_attention_impl``
``"block"`` on top (the ViT's fused sub-block kernels, its memory mode), in
the same call so that the four can be compared. For each piece it prints
one JSON line:

  wall_ms     host-clock ms per iteration, without the profiler, ending in
              a device sync
  device_ms   the kernels' summed device time per iteration (torch.profiler)
  busy        the union of the kernels' device intervals over the profiled
              host-clock wall, so 0 <= busy <= 1 (1 - busy is the idle share)
  kernels     kernels launched per iteration
  mhsa_short_ms  device ms per iteration of the ViT attention kernels (K1,
              both variants, forward and backward)
  flash_attention_ms  device ms per iteration of the flash attention
              kernels (K3, both variants: forward, dQ, dK/dV)
  layer_norm_fwd_ms, layer_norm_bwd_ms, hw_dropout_ms  device ms per
              iteration of the LayerNorm forward kernels (K4, every
              instantiation), of its backward (the row kernels and the
              kernel that sums their partials) and of the standalone
              dropout kernel (K5)
  top         the largest kernels: [device ms per iteration, launches per
              iteration, device ms per launch, name]

After each of the four settings a line holds its peak device memory; the
last line holds the card's name and power limit (nvidia-smi) and the
largest of those peaks.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

# The port's flash attention kernels (csrc/flash_attention.cu), not
# PyTorch's own flash kernels.
_FLASH_KERNEL = re.compile(r"flash_(fwd|dq|dkv)_(tc|scalar)_kernel")
_LN_BWD_KERNEL = re.compile(r"layer_norm_(bwd|param_grad)_kernel")


def _timed(fn, n: int) -> float:
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / n


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def profile_work(name: str, fn, n: int, warmup: int = 2,
                 top_n: int = 8) -> dict:
    """Time ``fn`` unprofiled, then under torch.profiler; one report."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    wall = _timed(fn, n)
    # A profiled warm-up window first: without it the tracer drops kernels
    # launched while it starts up (a quarter of 100 short launches on an
    # H100), and the per-iteration counts read low.
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        _timed(fn, n)
        prof.step()
        profiled_wall = _timed(fn, n)
        prof.step()
    # Annotation ranges (the schedule's "ProfilerStep#", the optimizer's
    # "Optimizer.step#") also land on the device's timeline; they span the
    # kernels under them and are no kernels.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("ProfilerStep", "Optimizer."))]
    by_name: dict = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e3 / n
        row[1] += 1 / n
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {"work": name, "wall_ms": wall, "profiled_wall_ms": profiled_wall,
            "device_ms": sum(r[0] for r in by_name.values()),
            "busy": busy_us / 1e3 / n / profiled_wall,
            "kernels": len(kernels) / n,
            "mhsa_short_ms": sum(ms for key, (ms, _) in by_name.items()
                                 if "mhsa_short" in key),
            "flash_attention_ms": sum(ms for key, (ms, _) in by_name.items()
                                      if _FLASH_KERNEL.search(key)),
            "layer_norm_fwd_ms": sum(ms for key, (ms, _) in by_name.items()
                                     if "layer_norm_fwd_kernel" in key),
            "layer_norm_bwd_ms": sum(ms for key, (ms, _) in by_name.items()
                                     if _LN_BWD_KERNEL.search(key)),
            "hw_dropout_ms": sum(ms for key, (ms, _) in by_name.items()
                                 if "hw_dropout_kernel" in key),
            "top": [[ms, count, ms / count, key[:90]]
                    for key, (ms, count) in top]}


def train_reports(model, device, label: str = "") -> list:
    """The flagship's train step and eval step at B=8, T=192."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_eval_step,
                                          make_train_step)

    batch_size, seq_len = 8, 192
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_batch_feed(batch_size, seq_len, image_size=224,
                                  seed=0).items()}
    loss_config = LossConfig(REFERENCE_CMD_WEIGHTS)
    state = create_train_state(dict(model.named_parameters()),
                               {"lr": 1e-5})
    train_step = make_train_step(model, loss_config)
    eval_step = make_eval_step(model, loss_config)
    holder = [state]

    def step():
        holder[0], _, _ = train_step(holder[0], batch, 0)

    name = (f"B={batch_size} T={seq_len}, {batch_size * (seq_len - 1)} "
            f"frames{label}")
    return [profile_work(f"train step, {name}", step, 2, top_n=16),
            profile_work(f"eval step, {name}", lambda: eval_step(batch), 2)]


def serve_reports(model, device) -> list:
    import numpy as np
    import torch

    from videocad_tpu_torch.infer import multiplex as mux
    from videocad_tpu_torch.infer.rollout import (prepare_for_decode,
                                                  sequential_inference)
    from videocad_tpu_torch.ops.fused_attention import mhsa_short

    lanes, seq_len, rollout_batch = 8, 187, 2
    params = prepare_for_decode(model)
    carry = mux.init_mux_carry(model, lanes, seq_len)
    rng = np.random.default_rng(0)

    def images(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape + (224, 224, 3),
                                             dtype=np.uint8)).to(device)

    for lane in range(lanes):
        mux.open_lane(model, carry, lane, images(1))
    frames = images(lanes)
    active = torch.ones(lanes, dtype=torch.bool, device=device)

    def tick():
        mux.mux_decode_step(model, params, frames, active, carry)
        carry["action"].cpu()

    cad = images(1)
    rollout_frames, rollout_cads = images(rollout_batch, seq_len), \
        images(rollout_batch)
    # The tick runs 2 + 3 * 10 times: inside the lanes' 187-step horizon.
    reports = [
        profile_work(f"serve tick, {lanes} lanes active, no HTTP",
                     tick, 10),
        profile_work("CAD encode (open_lane, B=1)",
                     lambda: mux.open_lane(model, carry, 0, cad), 5),
    ]
    with torch.no_grad():
        reports.append(profile_work(
            f"frame encode, B*T={rollout_batch * seq_len} frames",
            lambda: model.encode_frames(rollout_frames), 3))
    reports.append(profile_work(
        f"rollout B={rollout_batch} T={seq_len}",
        lambda: sequential_inference(model, rollout_frames, rollout_cads),
        2, warmup=1))
    gen = torch.Generator(device=device).manual_seed(0)
    for batch in (1, lanes, rollout_batch * seq_len,
                  rollout_batch * seq_len * 4):
        q, k, v = (torch.randn((batch, 50, 1024), generator=gen,
                               device=device).to(torch.bfloat16)
                   for _ in range(3))
        reports.append(profile_work(
            f"mhsa_short bf16 B={batch}",
            lambda: mhsa_short(q, k, v, None, 16), 100))
    return reports


def main(argv=None) -> None:
    import torch

    from videocad_tpu_torch.models.factory import create_model, flagship_config

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: the profile reads "
                           "device times and needs a CUDA card")
    model = create_model(flagship_config(), device=device)
    for report in serve_reports(model, device) + train_reports(model, device):
        print(json.dumps(report), flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"settings": "as the JSON has them",
                      "max_memory_gb": peak_gb}), flush=True)
    del model
    torch.cuda.empty_cache()
    two = {"ln_impl": "pallas", "dropout_impl": "pallas"}
    three = dict(two, attention_impl="pallas")
    # The fourth setting: the ViT's fused sub-block kernels beside the
    # three kernel settings (the ViT's memory mode).
    block = dict(three, vit_attention_impl="block")
    for label, settings in (
            (", ln_impl and dropout_impl pallas", two),
            (", attention_impl, ln_impl and dropout_impl pallas", three),
            (", vit_attention_impl block, attention_impl, ln_impl and "
             "dropout_impl pallas", block)):
        torch.cuda.reset_peak_memory_stats()
        kernels = create_model(dict(flagship_config(), **settings),
                               device=device)
        for report in train_reports(kernels, device, label):
            print(json.dumps(report), flush=True)
        settings_gb = torch.cuda.max_memory_allocated() / 1e9
        peak_gb = max(peak_gb, settings_gb)
        print(json.dumps({"settings": label.strip(", "),
                          "max_memory_gb": settings_gb}), flush=True)
        del kernels
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(json.dumps({"card": card[0] if card else None,
                      "max_memory_gb": peak_gb}), flush=True)


if __name__ == "__main__":
    main()
