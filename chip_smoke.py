#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videocad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an NVIDIA H100
(or another sm_90a card), the CUDA toolkit and PyTorch built for CUDA. It
imports nothing of JAX. Phases, each of which must pass:

  1. the card: its name and power limit (nvidia-smi), TF32 off;
  2. build of every kernel source under videocad_tpu_torch/csrc, one nvcc
     per source, all started together;
  3. each kernel against its plain PyTorch version at the shapes the paths
     give it, with the tolerance stated, both timed with CUDA events in
     turns: mhsa_short forward without and with dropout (the kept set must
     be the plain version's), its backward (also against autograd through
     the plain forward at float32, and bit-equal over two launches), the
     mask's properties, each in the variant its dtype takes (bf16 on the
     tensor cores, float32 scalar; the bf16 rows also time the scalar
     kernel on the same inputs), the two
     grayscale kernels (also timed on the device), layer_norm forward and
     backward (the exact-width instantiations checked by their counters;
     the backward also against float64, and bit-equal over two runs),
     hw_dropout (compared exactly, and its mask's properties), the
     LayerNorm kernels and hw_dropout also timed on the device beside the
     library call, with the host's cost of a call (host clock minus
     device time), and one library call per kernel that has one
     (scaled_dot_product_attention and its autograd backward, F.layer_norm
     and its backward, F.dropout) timed beside it as a yardstick that no
     path uses; then the
     three flash attention kernels (forward, dQ, dK/dV) at the decoder's
     shapes, causal and banded, without and with dropout, bf16 (the
     tensor-core variant, with the scalar kernels timed on the same
     inputs) and float32 (scalar), with a general mask at T != S, at B=2,
     T=47 and at D=16, and at the ViT's shape (1,528 frames, 16 heads of
     64, unmasked) with K1 timed on the same q, k, v: values, the kept set,
     the gradients (also against autograd through the plain forward at
     float32), the mask's properties, gradients that repeat bit for bit;
     then the four fused ViT sub-block entries (attention and MLP, forward
     and backward) at the flagship's widths, 1,528, 8 and 1 frames, bf16 and
     float32, dropout off and on: values, every gradient, the kept set of
     each of the four dropout sites read off outputs under constructed
     parameters, gradients against autograd through the plain forwards at
     float32, bit-equal repeats, and the port's own unfused sub-block timed
     beside them; all four entries run their tensor-core variant in bf16
     (checked by its counters) and the present kernels in float32, and
     their bf16 rows also time the present kernels on the same inputs,
     give device times beside the unfused sub-block's, each backward's
     device time by piece (kernel, weight-gradient products, their sums,
     torch.matmul) and the tensor-core kernels' registers and spills
     (nvcc -Xptxas -v);
  4. serve: the flagship config at full width in bf16 with seeded random
     weights, through the serving CLI's build_engine, behind the HTTP
     server; three staggered sessions step through ServingClient, some
     steps concurrent;
  5. rollout: sequential_inference on the flagship at B=2, T=187;
  6. train A: the flagship as its JSON has it (bf16, dropout 0.1, fused ViT
     attention), B=8, T=192, 224 x 224 uint8 frames: 1 warm-up and 3 timed
     train steps (12 + 12 launches of mhsa_short a step, all of its
     tensor-core variant), the eval loss before and after;
  7. train B: the same config with preprocess_impl "pallas", B=2, T=48, a
     256 x 256 CAD image: 2 train steps and an eval step, the eval loss
     against the plain preprocess path's;
  8. train C: the training entry point, videocad_tpu_torch.cli.train.main,
     on a synthetic dataset written to disk from a seed (32 sequences of
     150-191 frames of 224 x 224 x 3), the flagship with ln_impl and
     dropout_impl "pallas" (the LayerNorm forward and backward through
     their bf16 kernels of width 512 and 1,024, each checked by its
     counter): 2
     epochs of 2 steps at B=8 with validation, a rollout validation,
     checkpoints, the test evaluation and test rollout; then a second
     call with --resume for one epoch more. The epoch loop must not
     synchronise the host outside its logging fetch;
     the files of the logs layout must exist; the resumed run must start at
     epoch 2, step 4, with the checkpoint's parameters; the eval loss on
     the test split must fall;
  9. serve from train C's last checkpoint (--checkpoint_folder), one
     session of a few steps over HTTP;
 10. train D: cli.train.main once more on train C's dataset, with
     attention_impl, ln_impl and dropout_impl all "pallas" (the decoder's
     attention through the flash attention kernels, 16 + 16 + 16 launches
     a step, all of the tensor-core variant): one epoch of 2 steps at B=8
     with validation, a checkpoint and the test evaluation, again without
     a host synchronisation in the epoch loop;
 11. evaluate: videocad_tpu_torch.cli.evaluate.main on train D's
     best_model with --sequential: the sample CSVs, the first-mistake
     structure for every sequence of val and test, finite metrics, the
     plot files where matplotlib is installed;
 12. train E: cli.train.main once more on train C's dataset, with
     vit_attention_impl "block" on top of train D's settings (every ViT
     block through the fused sub-block kernels): one epoch of 2 steps at
     B=8 with validation, a checkpoint and the test evaluation, without a
     host synchronisation in the epoch loop, 12 launches of each of the
     four entries a step and none of mhsa_short, all of the tensor-core
     variant, and a peak device memory below train D's;
 13. the named configs beyond the flagship, each at its JSON's full width
     with random weights from seed 0: G, GenCAD
     (cad_past_10_actions_and_states_gencad: bf16, dropout 0.1, a 256² x 3
     edge image made here without OpenCV, so the CAD encoder runs K1 at
     T = 65, its wide instantiation) and M, three views
     (cad_5_actions_and_states_and_multiview): 1 warm-up and 3 timed
     train steps at B=8, T=192 (G: K1 12 + 12 a step, 6 + 6 of them wide,
     and the CAD encoder unchanged at learning rate 0), 8 sessions served
     behind HTTP with the session's edge image or views, a rollout at B=2,
     T=187; R, ResNet18-GN with three views
     (multiview_params_left_right_top, float32): 3 train steps at B=8,
     T=64 and the one-pass rollout; DT, the decision transformer
     (base_model, float32, ResNet): 3 train steps at B=8, T=64;
 14. reference: at the flagship's widths in float32, with the depth cut to
     2 + 2 layers, on the card and on the CPU (plain versions): the
     rollout's logits and one train step's loss and gradients compared,
     the train step again with ln_impl and dropout_impl "pallas", with
     attention_impl "pallas" as well, with vit_attention_impl "block" on
     top, with vit_attention_impl "pallas" on top instead (the ViT's
     attention through the flash attention kernels), and with
     vit_attention_impl "fused" beside vit_mlp_impl "block"; then the
     logits of G, M, R and DT at depth 2.

Phase S (after 13, before 14): the serving and inference layer on the
flagship (bf16, seed 0): sequential_inference at B=2, T=187 under
weight_quant none / int8 / int4, each timed (median of 3), its integers
within scale / 2 of the float32 weights, and the quantized rollout at
float32, depth 2, on the card against the CPU (1e-5, actions equal);
incremental_decode_step 187 times at B=2 under none and int8 (K1's
forward counted, tc), at float32, depth 2, against sequential_inference
(1e-5, actions equal); cad_saliency at B=8 (K1's backward) and
attention_rollout at B=8 (float32, depth 2, card against CPU, 1e-5); the
flagship exported by cli.export_model (8 lanes, int8), served by
cli.serve --artifact over HTTP (3 sessions x 10 steps) with the actions of
a live MuxEngine(weight_quant="int8"). G also runs cad_saliency (K1's
wide backward).

Phases N, Q, RM and W (after S, before 14): the training entry point's
last single-card options. N: train C's store converted to .vcb shards
(timed), an epoch of the C++ loader (data/native.py, built into
build/native/, native/ left byte for byte as it was) against DataPipeline
at B=8, bucket 192, byte for byte, both timed per batch on the host
clock; then cli.train.main --native_loader --quant int8 with ln_impl and
dropout_impl "pallas", one epoch of 2 steps with validation and a
checkpoint, no host sync in the epoch loop. Q: the flagship at full width
under quant "int8" and "int8_bwd", 1 + 3 train steps beside train A's
(torch._int_mm counted by ops/quant.py); the int8 path's integers on the
card equal the CPU's; at float32, depth 2, every quantized dense layer of
a step on the card against the CPU's on the same x and dy (1e-5), and the
whole step and rollout card vs CPU printed beside the card against itself
with every parameter moved one ulp (a quantized model is discontinuous).
RM: remat_encoder at full width with dropout, 1 + 3 steps: K1 18 + 12
launches a step, losses, gradients and parameters bit-equal to the steps
without it, a peak below train A's; an eval forward with frame_chunk 191
(8 chunks) against the unchunked one (2e-2 / 1e-3 of the largest logit,
max / mean). W: a reference-named .pt of the flagship from seed 0 in both
ViT generations warm-starts Experiment, which builds the generation the
checkpoint implies, with the source's weights and the logits of the
directly converted model.

Phase 3 also holds K1's wide instantiation (T = 65) against its plain
version at B = 8, 1 and 1,528, bf16 and float32, dropout 0 and 0.1:
values, the kept set (read off the output under shifted identity values,
in two pieces), bit-equal gradients, beside F.scaled_dot_product_attention.

The kernels' launch counters are set to 0 just before phase 4 and read
after phase 7, again just before phase 8 and read just after it, and so
around phases 10, 11 and 12, each of 13's four configs, S, N, Q and RM:
each kernel must have been launched by the path that claims it (the flash
attention kernels by train D, their forward by the evaluation as well, the
fused sub-block kernels by train E, K1's wide instantiation by G, K1's
forward and backward by S as well; N checks K1, K4 and K5 a step, RM K1's
18 + 12). The second-to-last lines are a JSON object of the kernels and
the card's nvidia-smi line; the last line is {"ok": true, "device": {...}}. Any
failure exits non-zero without that line.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCHES_BF16 = (1, 8, 374, 1496)  # CAD encode, a tick, B*T at B=2 and 8
SEQ, HEADS, WIDTH = 50, 16, 1024  # the flagship ViT: 50 tokens, 16 x 64
LANES, SEQ_LEN = 8, 187
STEPS = 10                        # served steps per session
TRAIN_BATCH, TRAIN_SEQ = 8, 192   # train A: 8 x 191 frames a step
TRAIN_FRAMES = TRAIN_BATCH * (TRAIN_SEQ - 1)
RATE = 0.1                        # the flagship's dropout
# Published peaks of the H100 SXM (dense): device memory bytes/s, and
# FLOP/s by operand type (bf16 on the tensor cores, f32 outside them).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def cuda_ms(fn, reps: int = 20, groups: int = 5, warmup: int = 3) -> float:
    """Median over ``groups`` of the mean time of ``reps`` launches."""
    import torch

    for _ in range(warmup):
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


def device_ms(fn, n: int = 10) -> float:
    """The device time of the kernels one call of ``fn`` launches
    (torch.profiler after a warm-up window, as cli/profile.py measures it):
    what a call costs the card when the host keeps up."""
    from videocad_tpu_torch.cli.profile import profile_work

    # The tracer may drop kernels of a window, every one of a window of
    # short launches, and never adds one: the largest of three windows.
    ms = max(profile_work("", fn, n)["device_ms"] for _ in range(3))
    check(ms > 0, "torch.profiler saw no kernel in three windows")
    return ms


def in_turns(kernel, plain, **kw):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, **kw) for f in (plain, kernel, kernel,
                                                  plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def three_in_turns(kernel, plain, library, plain_kw):
    """(kernel ms, plain ms, library ms) on the host clock, timed plain,
    kernel, library, library, kernel, plain; ``plain_kw`` are the plain
    version's repetitions (it is slow at the large shapes)."""
    p1, k1, l1, l2, k2, p2 = (cuda_ms(f, **kw) for f, kw in (
        (plain, plain_kw), (kernel, {}), (library, {}), (library, {}),
        (kernel, {}), (plain, plain_kw)))
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def with_device_times(row, kernel, library):
    """Add the kernel's and the library call's device times (torch.profiler)
    to ``row``, and the host's cost of a call beside each: host-clock time
    minus device time."""
    row["device_ms"] = device_ms(kernel)
    row["library_device_ms"] = device_ms(library)
    row["host_ms"] = row["ms"] - row["device_ms"]
    row["library_host_ms"] = row["library_ms"] - row["library_device_ms"]
    return row


def bound(n_bytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_flops),
            "bound_by": "bytes" if by_bytes >= by_flops else "operations"}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def attention_f64(q, k, v, keep=None, rate=0.0):
    """The forward kernel's function in float64 (no rounding of the
    weights); ``keep`` is the dropout mask, (B, H, T, T) bool."""
    import torch

    b, t, hd = q.shape
    d = hd // HEADS
    split = lambda x: x.double().reshape(b, t, HEADS, d).transpose(1, 2)  # noqa: E731
    weights = torch.softmax(split(q) @ split(k).transpose(-1, -2)
                            / math.sqrt(d), dim=-1)
    if keep is not None:
        weights = torch.where(keep, weights / (1.0 - rate), 0.0)
    return (weights @ split(v)).transpose(1, 2).reshape(b, t, hd)


def attention_grads_f64(q, k, v, g, keep=None, rate=0.0):
    """(dq, dk, dv) of the forward kernel's function by autograd in
    float64."""
    import torch

    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(attention_f64(*leaves, keep, rate), leaves,
                               g.double())


def randn(shape, gen, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def identity_values(batch, dtype):
    """V whose head h is [I_T | 0] (T x D): the kernel's output is then the
    (dropped, rounded) attention weights themselves."""
    import torch

    d = WIDTH // HEADS
    eye = torch.eye(SEQ, d, device="cuda", dtype=dtype)
    return eye.repeat(1, HEADS).expand(batch, SEQ, WIDTH).contiguous()


def weights_of(out):
    """(B, T, H*D) output under identity values -> (B, H, T, T) weights."""
    b = out.shape[0]
    return out.reshape(b, SEQ, HEADS, WIDTH // HEADS)[..., :SEQ].permute(
        0, 2, 1, 3)


def expected_variant(dtype) -> str:
    """The mhsa_short variant at the flagship's shapes: the tensor-core
    kernels for bf16, the scalar ones for float32."""
    import torch

    return "tc" if dtype == torch.bfloat16 else "scalar"


def variant_of(counted, run):
    """Call ``run``; returns its result and the variant it launched, read
    off ``counted.tc_launches``."""
    before = counted.tc_launches
    out = run()
    return out, "tc" if counted.tc_launches > before else "scalar"


def scalar_ms(fa, pick, tensors, seed, rate, **kw):
    """The time of the scalar kernel (entry ``pick``: 0 forward, 1
    backward) on the same bf16 inputs: the kernel the tc variant replaced
    at these shapes. Called through its C entry, on no path."""
    import torch

    q = tensors[0]
    b, t, hd = q.shape
    d = hd // HEADS
    entry = fa._entries["scalar"][pick]
    args = (*(x.data_ptr() for x in tensors), b, t, HEADS, d, 1,
            seed & 0xFFFFFFFF if rate else 0, rate,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = entry(*args)
        check(err == 0, f"the scalar mhsa_short kernel failed: {err}")
    return cuda_ms(run, **kw)


def k1_bound(row, tensors, flops_per_cell):
    """bound_ms, bound_by and the roofline share of a K1 row that moves
    ``tensors`` (B, T, H*D) tensors."""
    out = attention_bound(tensors, flops_per_cell)(row)
    out["roofline_share"] = out["bound_ms"] / row["ms"]
    return out


def phase_forward(fa):
    """mhsa_short forward against its plain version, dropout off; the rows
    of the checks and the library yardstick."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, dtype, max_tol, mean_tol in (
            [(b, torch.bfloat16, 2e-2, 1e-3)
             for b in BATCHES_BF16 + (TRAIN_FRAMES,)]
            + [(8, torch.float32, 1e-5, 1e-5)]):
        q, k, v = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(3))
        with torch.no_grad():
            got, variant = variant_of(
                fa.mhsa_short, lambda: fa.mhsa_short(q, k, v, None, HEADS))
            torch.cuda.synchronize()
            want = fa.mhsa_short_reference(q, k, v, None, HEADS)
            err = (got.float() - want.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            # Against float64 too: the plain version sums in another order
            # than the kernel and rounds the weights at the same place.
            f64_err = (got.double() - attention_f64(q, k, v)).abs().max()
            ms, plain_ms = in_turns(
                lambda: fa.mhsa_short(q, k, v, None, HEADS),
                lambda: fa.mhsa_short_reference(q, k, v, None, HEADS))
            row = {"kernel": "mhsa_short", "batch": b, "rate": 0.0,
                   "dtype": dtype_name(dtype), "variant": variant,
                   "max_abs_err": max_err, "mean_abs_err": mean_err,
                   "max_abs_err_vs_f64": f64_err.item(), "ms": ms,
                   "plain_ms": plain_ms}
            row.update(k1_bound(row, 4, 4))
            if b >= 374 and dtype == torch.bfloat16:
                row["scalar_ms"] = scalar_ms(
                    fa, 0, (q, k, v, torch.empty_like(q)), None, 0.0)
            if dtype == torch.bfloat16:
                # The yardstick: one library call for the same function on
                # the same inputs, as (B, H, T, D) views. No path uses it.
                heads = lambda x: x.view(b, SEQ, HEADS, -1).transpose(1, 2)  # noqa: E731
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    heads(q), heads(k), heads(v))
                lib_err = (sdpa().transpose(1, 2).reshape(b, SEQ, WIDTH)
                           .float() - got.float()).abs().max().item()
                row["library_ms"] = cuda_ms(sdpa)
                row["max_abs_diff_vs_library"] = lib_err
        print(f"mhsa_short {row}", flush=True)
        check(variant == expected_variant(dtype),
              f"mhsa_short B={b} {dtype} ran the {variant} kernel")
        check(math.isfinite(max_err) and max_err <= max_tol
              and mean_err <= mean_tol,
              f"mhsa_short B={b} {dtype}: max err {max_err} (tol {max_tol}),"
              f" mean err {mean_err} (tol {mean_tol})")
        rows.append(row)
    return rows


def phase_forward_dropout(fa, prng):
    """mhsa_short forward with dropout 0.1: values against the plain
    version, and the kept set, read off the output under identity values,
    identical to the plain version's and to the bit function's."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, dtype, max_tol, mean_tol in [
            (8, torch.bfloat16, 2e-2, 1e-3),
            (374, torch.bfloat16, 2e-2, 1e-3),
            (TRAIN_FRAMES, torch.bfloat16, 2e-2, 1e-3),
            (8, torch.float32, 1e-5, 1e-5)]:
        q, k, v = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(3))
        seed = 1000 + b
        with torch.no_grad():
            got, variant = variant_of(
                fa.mhsa_short,
                lambda: fa.mhsa_short(q, k, v, seed, HEADS, RATE))
            torch.cuda.synchronize()
            want = fa.mhsa_short_reference(q, k, v, seed, HEADS, RATE)
            err = (got.float() - want.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            keep = prng.keep_mask(prng.dropout_bits(
                seed, b, HEADS, SEQ, SEQ, device="cuda"), RATE)
            f64_err = (got.double() - attention_f64(q, k, v, keep, RATE)
                       ).abs().max().item()
            eye = identity_values(b, dtype)
            kept = weights_of(fa.mhsa_short(q, k, eye, seed, HEADS, RATE)) > 0
            kept_plain = weights_of(fa.mhsa_short_reference(
                q, k, eye, seed, HEADS, RATE)) > 0
            same_set = torch.equal(kept, kept_plain) and torch.equal(kept,
                                                                     keep)
            reps = dict(reps=3, groups=3, warmup=1) if b > 8 else {}
            ms, plain_ms = in_turns(
                lambda: fa.mhsa_short(q, k, v, seed, HEADS, RATE),
                lambda: fa.mhsa_short_reference(q, k, v, seed, HEADS, RATE),
                **reps)
        row = {"kernel": "mhsa_short", "batch": b, "rate": RATE,
               "dtype": dtype_name(dtype), "variant": variant,
               "max_abs_err": max_err, "mean_abs_err": mean_err,
               "max_abs_err_vs_f64": f64_err,
               "kept_set_identical": same_set,
               "drop_share": 1.0 - kept.float().mean().item(), "ms": ms,
               "plain_ms": plain_ms}
        row.update(k1_bound(row, 4, 4))
        if b >= 374 and dtype == torch.bfloat16:
            row["scalar_ms"] = scalar_ms(
                fa, 0, (q, k, v, torch.empty_like(q)), seed, RATE)
        if dtype == torch.bfloat16:
            # The library's call for the same function (its own mask).
            heads = lambda x: x.view(b, SEQ, HEADS, -1).transpose(1, 2)  # noqa: E731
            with torch.no_grad():
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        heads(q), heads(k), heads(v), dropout_p=RATE))
        print(f"mhsa_short {row}", flush=True)
        check(variant == expected_variant(dtype),
              f"mhsa_short B={b} {dtype} rate {RATE} ran the {variant} "
              "kernel")
        check(same_set, f"mhsa_short B={b} {dtype} rate {RATE}: the kernel's "
              "kept set is not the plain version's")
        check(math.isfinite(max_err) and max_err <= max_tol
              and mean_err <= mean_tol,
              f"mhsa_short B={b} {dtype} rate {RATE}: max err {max_err} "
              f"(tol {max_tol}), mean err {mean_err} (tol {mean_tol})")
        rows.append(row)
    return rows


def sdpa_backward_ms(q, k, v, g, rate):
    """The yardstick of the backward: autograd's backward through
    F.scaled_dot_product_attention (its own dropout mask) on the same
    (B, H, T, D) views, the forward outside the timed window."""
    import torch
    import torch.nn.functional as F

    b = q.shape[0]
    heads = lambda x: x.view(b, SEQ, HEADS, -1).transpose(1, 2)  # noqa: E731
    leaves = [heads(x).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, dropout_p=rate)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, heads(g),
                                               retain_graph=True))


def phase_backward(fa, prng):
    """mhsa_short backward against its plain version (float32: 1e-5; bf16:
    2e-2 max, 1e-3 mean) and, at float32, against autograd through the
    plain forward; the error against float64 autograd is printed too; a
    second launch must give the same gradients to the bit."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, dtype, rate in [(b, dtype, rate)
                           for rate in (0.0, RATE)
                           for b, dtype in [(8, torch.bfloat16),
                                            (374, torch.bfloat16),
                                            (TRAIN_FRAMES, torch.bfloat16),
                                            (8, torch.float32)]]:
        bf16 = dtype == torch.bfloat16
        max_tol, mean_tol = (2e-2, 1e-3) if bf16 else (1e-5, 1e-5)
        q, k, v, g = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(4))
        seed = 2000 + b if rate else None
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.mhsa_short_backward.launches
        _, variant = variant_of(
            fa.mhsa_short_backward,
            lambda: fa.mhsa_short(*leaves, seed, HEADS, rate).backward(g))
        torch.cuda.synchronize()
        check(fa.mhsa_short_backward.launches == before + 1,
              "autograd did not launch the backward kernel once")
        got = [x.grad for x in leaves]
        with torch.no_grad():
            want = fa.mhsa_short_backward_reference(q, k, v, g, seed, HEADS,
                                                    rate)
            again = fa.mhsa_short_backward(q, k, v, g, seed, HEADS, rate)
        repeats = all(torch.equal(a, x) for a, x in zip(got, again))
        del again
        errs = [(a.float() - w.float()).abs() for a, w in zip(got, want)]
        max_err = max(e.max().item() for e in errs)
        mean_err = max(e.mean().item() for e in errs)
        keep = None if not rate else prng.keep_mask(prng.dropout_bits(
            seed, b, HEADS, SEQ, SEQ, device="cuda"), rate)
        f64_err = max((a.double() - w).abs().max().item() for a, w in
                      zip(got, attention_grads_f64(q, k, v, g, keep, rate)))
        del keep
        row = {"kernel": "mhsa_short_bwd", "batch": b, "rate": rate,
               "dtype": dtype_name(dtype), "variant": variant,
               "max_abs_err": max_err, "mean_abs_err": mean_err,
               "max_abs_err_vs_f64": f64_err, "bit_equal_repeat": repeats}
        if not bf16:
            again = [x.clone().requires_grad_() for x in (q, k, v)]
            ref = fa.mhsa_short_reference(*again, seed, HEADS, rate)
            auto = torch.autograd.grad(ref, again, g)
            row["max_abs_err_vs_autograd"] = max(
                (a - w).abs().max().item() for a, w in zip(got, auto))
        with torch.no_grad():
            reps = dict(reps=3, groups=3, warmup=1) if b > 8 and rate else {}
            row["ms"], row["plain_ms"] = in_turns(
                lambda: fa.mhsa_short_backward(q, k, v, g, seed, HEADS, rate),
                lambda: fa.mhsa_short_backward_reference(q, k, v, g, seed,
                                                         HEADS, rate),
                **reps)
            row.update(k1_bound(row, 7, 10))
            if b >= 374 and bf16:
                outs = [torch.empty_like(q) for _ in range(3)]
                row["scalar_ms"] = scalar_ms(fa, 1, (q, k, v, g, *outs),
                                             seed, rate)
                del outs
        if b >= 374 and bf16:
            row["library_ms"] = sdpa_backward_ms(q, k, v, g, rate)
        print(f"mhsa_short_bwd {row}", flush=True)
        check(variant == expected_variant(dtype),
              f"mhsa_short_bwd B={b} {dtype} rate {rate} ran the {variant} "
              "kernel")
        check(repeats, f"mhsa_short_bwd B={b} {dtype} rate {rate}: two "
              "launches gave different gradients")
        check(math.isfinite(max_err) and max_err <= max_tol
              and mean_err <= mean_tol,
              f"mhsa_short_bwd B={b} {dtype} rate {rate}: max err {max_err} "
              f"(tol {max_tol}), mean err {mean_err} (tol {mean_tol})")
        check(row.get("max_abs_err_vs_autograd", 0.0) <= 1e-5,
              f"mhsa_short_bwd B={b} float32 rate {rate}: differs from "
              f"autograd by {row.get('max_abs_err_vs_autograd')}")
        rows.append(row)
    return rows


def phase_mask(fa):
    """The mask's properties on the card, for each variant (float32:
    scalar, bf16: tensor cores): the drop share, another seed gives another
    mask, and the backward of a call redraws its forward's mask (identity
    values and an identity output gradient make the forward return the
    dropped weights and dv their transpose)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    b = 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(2))
        eye = identity_values(b, dtype)
        with torch.no_grad():
            out, variant = variant_of(
                fa.mhsa_short, lambda: fa.mhsa_short(q, k, eye, 31, HEADS,
                                                     RATE))
            kept = weights_of(out) > 0
            other = weights_of(fa.mhsa_short(q, k, eye, 32, HEADS, RATE)) > 0
            (_, _, dv), bwd_variant = variant_of(
                fa.mhsa_short_backward,
                lambda: fa.mhsa_short_backward(q, k, eye, eye, 31, HEADS,
                                               RATE))
        share = 1.0 - kept.float().mean().item()
        kept_bwd = weights_of(dv).transpose(-1, -2) > 0
        print(f"mask ({dtype_name(dtype)}, {variant} / {bwd_variant}): drop "
              f"share {share:.5f} over B={b} (rate {RATE}); seeds differ: "
              f"{not torch.equal(kept, other)}; backward redraws the "
              f"forward's mask: {torch.equal(kept, kept_bwd)}", flush=True)
        check(variant == bwd_variant == expected_variant(dtype),
              f"the mask phase at {dtype} ran {variant} / {bwd_variant}")
        check(abs(share - RATE) <= 0.002, f"drop share {share} is not {RATE}")
        check(not torch.equal(kept, other), "two seeds drew one mask")
        check(torch.equal(kept, kept_bwd),
              f"the backward did not redraw the forward's mask ({dtype})")


def phase_gray(pp):
    """The grayscale kernels against grayscale_normalize: the plain one at
    the train step's frames (max abs err <= 1e-6: the division may differ
    by one ulp), the resize one at 256 x 256 CAD images (<= 1e-5: its two
    blends may round apart from the plain version's matrix products)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for name, shape, target, tol in [
            ("gray_normalize", (TRAIN_FRAMES, 224, 224, 3), None, 1e-6),
            ("gray_resize_normalize", (8, 256, 256, 3), (224, 224), 1e-5)]:
        images = torch.randint(0, 256, shape, generator=gen,
                               dtype=torch.uint8, device="cuda")
        got = pp.grayscale_normalize_fused(images, True, target)
        torch.cuda.synchronize()
        want = pp.grayscale_normalize(images, True, target)
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"{name}: shape {tuple(got.shape)} dtype {got.dtype}")
        max_err = (got - want).abs().max().item()
        # Float64, every product and sum exact to the end.
        x = images.double()
        gray = x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
        if target is not None:
            rh, rw = (torch.from_numpy(pp._resize_matrix(n, 224)).double()
                      .cuda() for n in shape[1:3])
            gray = torch.einsum("oh,nhw,pw->nop", rh, gray, rw)
        f64_err = (got[..., 0].double() - (gray / 127.5 - 1.0)).abs().max()
        del x, gray, want
        kernel = lambda: pp.grayscale_normalize_fused(  # noqa: E731
            images, True, target)
        ms, plain_ms = in_turns(
            kernel, lambda: pp.grayscale_normalize(images, True, target))
        row = {"kernel": name, "shape": list(shape), "max_abs_err": max_err,
               "max_abs_err_vs_f64": f64_err.item(), "ms": ms,
               "plain_ms": plain_ms, "device_ms": device_ms(kernel)}
        row.update(bound(images.numel() + got.numel() * 4,
                         7.0 * got.numel() if target is None
                         else 30.0 * got.numel(), "float32"))
        print(f"{name} {row}", flush=True)
        check(math.isfinite(max_err) and max_err <= tol,
              f"{name}: max err {max_err} (tol {tol})")
        rows.append(row)
        del images, got
        torch.cuda.empty_cache()
    return rows


LN_SHAPES = ((76400, 512), (74872, 1024), (400, 512))   # rows x d
LN_EPS = 1e-5
DROPOUT_SHAPES = ((1528, 50, 512), (8, 4, 191, 191), (1000003,))


def ulps(got, want):
    """|got - want| in units of the last place of bf16 (8 significant
    bits) at ``want``'s magnitude; where ``want`` is so near 0 that this
    unit is below the float32 tolerance 1e-5 (a cancellation in float32
    arithmetic, whose absolute error does not shrink with the result), in
    units of 1e-5."""
    import torch

    w = want.float()
    exponent = torch.frexp(w.abs().clamp_min(1e-30))[1]
    unit = torch.ldexp(torch.ones_like(w), exponent - 8).clamp_min(1e-5)
    return (got.float() - w).abs() / unit


def layer_norm_f64(x, scale, bias):
    import torch.nn.functional as F

    return F.layer_norm(x.double(), x.shape[-1:], scale.double(),
                        bias.double(), LN_EPS)


def phase_layer_norm(ln):
    """layer_norm forward and backward against their plain versions and
    against float64. Tolerances: a bf16 output within one unit of its last
    place (the kernel sums a row in another order than the plain version,
    which can move the one rounding to bf16; 1e-5 where the output is so
    near 0 that its last place is smaller), a float32 output within 1e-5;
    dscale and dbias within 1e-4 of their largest entry (sums over up to
    76,400 rows in another order). The library yardsticks, on no path:
    F.layer_norm and its autograd backward."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for (n, d), dtype in [(shape, dtype) for shape in LN_SHAPES
                          for dtype in (torch.bfloat16, torch.float32)]:
        bf16 = dtype == torch.bfloat16
        x = (randn((n, d), gen, torch.float32) * 2.0 + 0.5).to(dtype)
        g = randn((n, d), gen, dtype)
        scale = 1.0 + 0.1 * randn((d,), gen, torch.float32)
        bias = 0.1 * randn((d,), gen, torch.float32)
        itemsize = 2 if bf16 else 4

        def errors(got, want):
            err = (got.float() - want.float()).abs().max().item()
            return err, ulps(got, want).max().item()

        variant = f"{dtype_name(dtype)}/{d}"    # the exact-width kernel
        counted = ln.layer_norm.variant_launches
        before = counted[variant]
        with torch.no_grad():
            got = ln.layer_norm(x, scale, bias, LN_EPS)
            torch.cuda.synchronize()
            check(counted[variant] == before + 1,
                  f"layer_norm_fwd {n}x{d} {dtype}: the {variant} kernel "
                  "did not run")
            want = ln.layer_norm_plain(x, scale, bias, LN_EPS)
            max_err, max_ulps = errors(got, want)
            exact = layer_norm_f64(x, scale, bias)
            f64_err = (got.double() - exact).abs().max().item()
            del exact
            lib_scale, lib_bias = scale.to(dtype), bias.to(dtype)
            kernel = lambda: ln.layer_norm(x, scale, bias, LN_EPS)  # noqa: E731
            library = lambda: F.layer_norm(  # noqa: E731
                x, (d,), lib_scale, lib_bias, LN_EPS)
            ms, plain_ms, library_ms = three_in_turns(
                kernel, lambda: ln.layer_norm_plain(x, scale, bias, LN_EPS),
                library, {})
            row = {"kernel": "layer_norm_fwd", "rows": n, "d": d,
                   "dtype": dtype_name(dtype), "variant": variant,
                   "max_abs_err": max_err, "max_err_ulps": max_ulps,
                   "max_abs_err_vs_f64": f64_err,
                   "tolerance": "1 ulp of bf16" if bf16 else "1e-5",
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
            with_device_times(row, kernel, library)
        row.update(bound(2 * n * d * itemsize + 8 * d, 8.0 * n * d,
                         "float32"))
        row["roofline_share"] = row["bound_ms"] / row["device_ms"]
        print(f"layer_norm_fwd {row}", flush=True)
        check(math.isfinite(max_err)
              and (max_ulps <= 1.0 if bf16 else max_err <= 1e-5),
              f"layer_norm_fwd {n}x{d} {dtype}: max err {max_err} "
              f"({max_ulps} ulps)")
        check(f64_err <= (0.05 if bf16 else 1e-5),
              f"layer_norm_fwd {n}x{d} {dtype}: {f64_err} from float64")
        rows.append(row)
        del got, want

        # Backward, through autograd: one launch of the backward kernel, of
        # the exact-width instantiation.
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        before = ln.layer_norm_backward.launches
        counted = ln.layer_norm_backward.variant_launches
        before_variant = counted[variant]
        ln.layer_norm(*leaves, LN_EPS).backward(g)
        torch.cuda.synchronize()
        check(ln.layer_norm_backward.launches == before + 1,
              "autograd did not launch the LayerNorm backward once")
        check(counted[variant] == before_variant + 1,
              f"layer_norm_bwd {n}x{d} {dtype}: the {variant} kernel did "
              "not run")
        dx, dscale, dbias = (t.grad for t in leaves)
        with torch.no_grad():
            want_dx, want_dscale, want_dbias = ln.layer_norm_backward_plain(
                x, scale, g, LN_EPS)
        max_err, max_ulps = errors(dx, want_dx)
        rel = lambda a, w: ((a - w).abs().max()  # noqa: E731
                            / w.abs().max()).item()
        param_err = max(rel(dscale, want_dscale), rel(dbias, want_dbias))
        again = [t.double().requires_grad_() for t in (x, scale, bias)]
        exact = torch.autograd.grad(layer_norm_f64(*again), again, g.double())
        f64_err = (dx.double() - exact[0]).abs().max().item()
        f64_param_err = max(rel(dscale.double(), exact[1]),
                            rel(dbias.double(), exact[2]))
        del again, exact, want_dx
        lib = [x.clone().requires_grad_(), lib_scale.clone().requires_grad_(),
               lib_bias.clone().requires_grad_()]
        lib_out = F.layer_norm(lib[0], (d,), lib[1], lib[2], LN_EPS)
        kernel = lambda: ln.layer_norm_backward(  # noqa: E731
            x, scale, g, LN_EPS)
        library = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib, g, retain_graph=True)
        with torch.no_grad():
            ms, plain_ms = in_turns(
                kernel,
                lambda: ln.layer_norm_backward_plain(x, scale, g, LN_EPS))
        library_ms = cuda_ms(library)
        row = {"kernel": "layer_norm_bwd", "rows": n, "d": d,
               "dtype": dtype_name(dtype), "variant": variant,
               "max_abs_err": max_err,
               "max_err_ulps": max_ulps, "max_abs_err_vs_f64": f64_err,
               "param_grad_rel_err": param_err,
               "param_grad_rel_err_vs_f64": f64_param_err,
               "tolerance": ("dx 1 ulp of bf16" if bf16 else "dx 1e-5")
               + ", dscale and dbias 1e-4 of the largest entry",
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        with_device_times(row, kernel, library)
        del lib, lib_out
        row.update(bound(3 * n * d * itemsize + 12 * d, 16.0 * n * d,
                         "float32"))
        row["roofline_share"] = row["bound_ms"] / row["device_ms"]
        # Two runs give the same bits: partials a block, summed in a fixed
        # order, no atomics.
        first, second = kernel(), kernel()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"layer_norm_bwd {n}x{d} {dtype}: two runs differ")
        del first, second
        print(f"layer_norm_bwd {row}", flush=True)
        check(math.isfinite(max_err)
              and (max_ulps <= 1.0 if bf16 else max_err <= 1e-5),
              f"layer_norm_bwd {n}x{d} {dtype}: dx max err {max_err} "
              f"({max_ulps} ulps)")
        check(param_err <= 1e-4 and f64_param_err <= 1e-4,
              f"layer_norm_bwd {n}x{d} {dtype}: dscale / dbias differ by "
              f"{param_err} (plain), {f64_param_err} (float64) of the "
              "largest entry")
        rows.append(row)
        del x, g, dx, leaves
        torch.cuda.empty_cache()
    # A width off the vector grid takes the scalar path of the same kernels.
    x = randn((37, 100), gen, torch.bfloat16)
    scale, bias = (randn((100,), gen, torch.float32) for _ in range(2))
    before = ln.layer_norm.variant_launches["bfloat16/scalar"]
    with torch.no_grad():
        odd = ulps(ln.layer_norm(x, scale, bias, LN_EPS),
                   ln.layer_norm_plain(x, scale, bias, LN_EPS)).max().item()
    check(odd <= 1.0, f"layer_norm_fwd 37x100 bf16: {odd} ulps")
    check(ln.layer_norm.variant_launches["bfloat16/scalar"] == before + 1,
          "layer_norm_fwd 37x100 bf16 did not take the scalar kernel")
    try:
        ln.layer_norm(randn((4, 2048), gen, torch.bfloat16),
                      torch.ones(2048, device="cuda"),
                      torch.zeros(2048, device="cuda"))
        fail("layer_norm took d = 2048 on the card")
    except ValueError:
        pass
    print(f"layer_norm: 37x100 bf16 (scalar path) within {odd} ulps; d = 2048 "
          "raises", flush=True)
    return rows


def phase_hw_dropout(dr):
    """hw_dropout against its plain version, compared exactly (max abs err
    0 and the kept set identical), and the mask's properties on the card.
    The library yardstick, on no path: F.dropout."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for shape, dtype in [(shape, dtype) for shape in DROPOUT_SHAPES
                         for dtype in (torch.bfloat16, torch.float32)]:
        x = randn(shape, gen, dtype)
        x[x == 0] = 1.0
        seed = 3000 + len(shape)
        with torch.no_grad():
            got = dr.hw_dropout(x, seed, RATE)
            torch.cuda.synchronize()
            want = dr.hw_dropout_plain(x, seed, RATE)
            max_err = (got.float() - want.float()).abs().max().item()
            same_set = torch.equal(got != 0, want != 0)
            share = (got == 0).float().mean().item()
            del want
            kernel = lambda: dr.hw_dropout(x, seed, RATE)  # noqa: E731
            library = lambda: F.dropout(x, RATE, True)  # noqa: E731
            ms, plain_ms, library_ms = three_in_turns(
                kernel, lambda: dr.hw_dropout_plain(x, seed, RATE), library,
                dict(reps=3, groups=3, warmup=1))
            n = x.numel()
            row = {"kernel": "hw_dropout", "shape": list(shape),
                   "dtype": dtype_name(dtype), "max_abs_err": max_err,
                   "kept_set_identical": same_set, "drop_share": share,
                   "tolerance": "0 (exact)", "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms}
            with_device_times(row, kernel, library)
        # Philox: about 90 integer operations per four elements.
        row.update(bound(2 * n * (2 if dtype == torch.bfloat16 else 4),
                         23.0 * n, "float32"))
        row["roofline_share"] = row["bound_ms"] / row["device_ms"]
        print(f"hw_dropout {row}", flush=True)
        check(max_err == 0.0 and same_set,
              f"hw_dropout {shape} {dtype}: differs from its plain version "
              f"(max err {max_err}, kept set identical: {same_set})")
        sigma = math.sqrt(RATE * (1 - RATE) / n)
        check(abs(share - RATE) <= 4 * sigma,
              f"hw_dropout {shape} {dtype}: drop share {share}, more than "
              f"4 sigma ({4 * sigma}) from {RATE}")
        rows.append(row)
        del x, got
        torch.cuda.empty_cache()

    # The mask's properties, on the largest tensor.
    x = randn(DROPOUT_SHAPES[0], gen, torch.bfloat16)
    x[x == 0] = 1.0
    flat = x.reshape(-1)
    k = DROPOUT_SHAPES[2][0]
    with torch.no_grad():
        full = dr.hw_dropout(x, 41, RATE)
        same = torch.equal(full, dr.hw_dropout(x, 41, RATE))
        other = not torch.equal(full != 0, dr.hw_dropout(x, 42, RATE) != 0)
        # A flat prefix runs under another grid, and its odd length and, for
        # the view that starts one element in, its alignment take the scalar
        # accesses: the mask must be the prefix of the full mask all the same.
        prefix = torch.equal(dr.hw_dropout(flat[:k], 41, RATE),
                             full.reshape(-1)[:k])
        shifted = torch.equal(dr.hw_dropout(flat[1:k], 41, RATE) != 0,
                              full.reshape(-1)[:k - 1] != 0)
    leaf = x.clone().requires_grad_()
    g = randn(DROPOUT_SHAPES[0], gen, torch.bfloat16)
    before = dr.hw_dropout.launches
    dr.hw_dropout(leaf, 41, RATE).backward(g)
    check(dr.hw_dropout.launches == before + 2,
          "hw_dropout under autograd did not launch twice (forward, backward)")
    with torch.no_grad():
        backward = torch.equal(leaf.grad, dr.hw_dropout(g, 41, RATE))
    print(f"hw_dropout mask: same seed same mask: {same}; another seed "
          f"another: {other}; flat prefix of {k} elements draws the prefix of "
          f"the mask: {prefix}; so does an unaligned view: {shifted}; the "
          f"backward is the forward on the cotangent: {backward}", flush=True)
    check(same and other and prefix and shifted and backward,
          "hw_dropout's mask failed a property")
    return rows


FLASH_SHAPE = (TRAIN_BATCH, TRAIN_SEQ - 1, 4, 256)  # the decoder's q, k, v
FLASH_WINDOW = 10                                   # the flagship's band
FLASH_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv")


def flash_close(got, want, bf16, rounding=0.0):
    """(max abs err, its limit, within?). The limit: 2e-5 of the tensor's
    largest entry at float32 (sums over 256 columns and up to 191 keys in
    another order); for a bf16 output that, plus one unit in the last place
    of bf16 at the value's magnitude (the output's one rounding may fall to
    the other side). For the tc variant ``rounding`` of the largest entry
    takes the place of 2e-5: the tensor cores take the dropped weights and
    ds rounded to bf16, as the TPU kernels' precision=None products do,
    where the plain versions keep float32 (FLASH_FWD_ROUNDING forward,
    FLASH_GRAD_ROUNDING for dq, dk, dv)."""
    import torch

    w = want.float()
    scale = w.abs().max().item()
    tol = rounding * scale if rounding else 2e-5 * max(1.0, scale)
    err = (got.float() - w).abs()
    excess = err
    if bf16:
        exponent = torch.frexp(w.abs().clamp_min(1e-30))[1]
        excess = err - torch.ldexp(torch.ones_like(w), exponent - 8)
    return err.max().item(), tol, excess.max().item() <= tol


FLASH_FWD_ROUNDING, FLASH_GRAD_ROUNDING = 2.0 ** -9, 2.0 ** -7


def flash_variant(dtype, d) -> str:
    """The flash attention variant a case must run: the tensor-core kernels
    for bf16 with D a multiple of 16, the scalar ones otherwise."""
    import torch

    return "tc" if dtype == torch.bfloat16 and d % 16 == 0 else "scalar"


def flash_scalar_ms(fl, pick, tensors, q, k, mask, seed, rate, **kw):
    """The time of the scalar flash kernel (entry ``pick``: 0 forward, 1
    dQ, 2 dK/dV) on the same bf16 inputs: the kernel the tc variant
    replaced. Called through its C entry, on no path."""
    import torch

    b, t, h, d = q.shape
    s = k.shape[1]
    mode, window, mask_tensor = fl._mask_args(mask, t, s, q.device)
    entry = fl._entries["scalar"][pick]
    args = (*(x.data_ptr() for x in tensors),
            None if mask_tensor is None else mask_tensor.data_ptr(), b, t, s,
            h, d, 1, mode, window, seed & 0xFFFFFFFF if rate else 0, rate,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = entry(*args)
        check(err == 0, f"the scalar flash attention kernel {pick} failed: "
              f"{err}")
    return cuda_ms(run, **kw)


def flash_case(fl, prng, gen, b, t, s, d, dtype, mask, kind, rate, timed,
               h=FLASH_SHAPE[2], tensors=None):
    """One shape of the flash attention kernels against their plain
    versions, on ``tensors`` (q, k, v, g) or new random ones; returns the
    three rows (forward, dQ, dK/dV)."""
    import torch
    import torch.nn.functional as F

    bf16 = dtype == torch.bfloat16
    if tensors is None:
        q, g = (randn((b, t, h, d), gen, dtype) for _ in range(2))
        k, v = (randn((b, s, h, d), gen, dtype) for _ in range(2))
    else:
        q, k, v, g = tensors
    seed = 4000 + t if rate else None
    label = f"B={b} T={t} S={s} D={d} {dtype_name(dtype)} {kind} rate {rate}"
    allowed = (torch.ones((t, s), dtype=torch.bool, device="cuda")
               if mask is None else mask.tensor("cuda")
               if isinstance(mask, fl.BandMask) else mask)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counted = [getattr(fl, name) for name in FLASH_KERNELS]
    marks = [(c.launches, c.tc_launches) for c in counted]
    out = fl.flash_attention(*leaves, mask, seed, rate)
    out.backward(g)
    torch.cuda.synchronize()
    check([c.launches for c in counted] == [m[0] + 1 for m in marks],
          f"flash attention {label}: autograd did not launch each of the "
          "three kernels once")
    ran = {"tc" if c.tc_launches > m[1] else "scalar"
           for c, m in zip(counted, marks)}
    variant = flash_variant(dtype, d)
    check(ran == {variant}, f"flash attention {label} ran the {ran} "
          f"kernels, expected {variant}")
    tc = variant == "tc"
    grads = [x.grad for x in leaves]
    with torch.no_grad():
        want, want_lse = fl.flash_attention_reference(q, k, v, mask, seed,
                                                      rate)
        got, lse = fl.flash_attention_forward(q, k, v, mask, seed, rate)
        want_grads = fl.flash_attention_backward_reference(
            q, k, v, mask, seed, got, lse, g, rate)
    fwd_err, fwd_tol, fwd_ok = flash_close(
        out, want, bf16, FLASH_FWD_ROUNDING if tc else 0.0)
    lse_err = (lse - want_lse).abs().max().item()
    checks = [flash_close(a, w, bf16, FLASH_GRAD_ROUNDING if tc else 0.0)
              for a, w in zip(grads, want_grads)]
    rows = [{"kernel": name, "batch": b, "q_len": t, "kv_len": s, "d": d,
             "dtype": dtype_name(dtype), "mask": kind, "rate": rate,
             "variant": variant}
            for name in FLASH_KERNELS]
    rows[0].update(max_abs_err=fwd_err, tolerance=fwd_tol, lse_err=lse_err)
    rows[1].update(max_abs_err=checks[0][0], tolerance=checks[0][1])
    rows[2].update(max_abs_err=max(checks[1][0], checks[2][0]),
                   tolerance=min(checks[1][1], checks[2][1]))
    check(fwd_ok and lse_err <= 1e-4,
          f"flash attention {label}: forward max err {fwd_err} (limit "
          f"{fwd_tol}), lse err {lse_err} (limit 1e-4)")
    for name, (err, tol, ok) in zip(("dq", "dk", "dv"), checks):
        check(ok, f"flash attention {label}: {name} max err {err} (limit "
              f"{tol})")
    if not bf16:
        again = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = fl.flash_attention_reference(*again, mask, seed, rate)[0]
        auto = [flash_close(a, w, False) for a, w in
                zip(grads, torch.autograd.grad(ref, again, g))]
        rows[1]["max_abs_err_vs_autograd"] = auto[0][0]
        rows[2]["max_abs_err_vs_autograd"] = max(auto[1][0], auto[2][0])
        check(all(ok for _, _, ok in auto),
              f"flash attention {label}: gradients differ from autograd "
              f"through the plain forward by {[a[0] for a in auto]}")
    if rate:
        # The kept set, read off the output under V = [I | 0] per head, and
        # off dv under g = [I | 0]: the plain version's and the bit
        # function's, in the forward and in the dK/dV kernel.
        eye_v = torch.eye(s, d, device="cuda", dtype=dtype).view(
            1, s, 1, d).expand(b, s, h, d).contiguous()
        eye_g = torch.eye(t, d, device="cuda", dtype=dtype).view(
            1, t, 1, d).expand(b, t, h, d).contiguous()
        cols, rows_seen = min(s, d), min(t, d)
        with torch.no_grad():
            dropped, lse_d = fl.flash_attention_forward(q, k, eye_v, mask,
                                                        seed, rate)
            plain = fl.flash_attention_reference(q, k, eye_v, mask, seed,
                                                 rate)[0]
            clean = fl.flash_attention_forward(q, k, eye_v, mask)[0]
            dv = fl.flash_attention_backward(q, k, v, mask, seed, got, lse,
                                             eye_g, rate)[2]
        keep = prng.keep_mask(prng.dropout_bits(
            seed, b, h, t, s, device="cuda",
            key_word=prng.FLASH_KEY_WORD), rate)
        weights = lambda o: o[..., :cols].permute(0, 2, 1, 3)  # noqa: E731
        positive = weights(clean) > 0
        kept = weights(dropped) > 0
        same = (torch.equal(kept, weights(plain) > 0)
                and torch.equal(kept, keep[..., :cols] & positive))
        # dv[b, j, h, i] = (w * drop)[b, h, i, j] for i < D.
        kept_bwd = dv[..., :rows_seen].permute(0, 2, 3, 1) > 0
        w_pos = (torch.exp(torch.einsum(
            "bthd,bshd->bhts", q.float() / math.sqrt(d), k.float())
            - lse[..., None]) > 0) & allowed
        same_bwd = torch.equal(kept_bwd,
                               (keep & w_pos)[:, :, :rows_seen, :])
        share = 1.0 - kept.sum().item() / positive.sum().item()
        sigma = math.sqrt(rate * (1 - rate) / positive.sum().item())
        rows[0].update(kept_set_identical=same, drop_share=share)
        rows[2].update(kept_set_identical=same_bwd)
        check(same, f"flash attention {label}: the forward's kept set is "
              "not the plain version's")
        check(same_bwd, f"flash attention {label}: the dK/dV kernel's kept "
              "set is not the forward's")
        check(torch.equal(lse, lse_d),
              f"flash attention {label}: the denominator did not sum the "
              "undropped weights (lse moved with the values)")
        check(abs(share - rate) <= 4 * sigma,
              f"flash attention {label}: drop share {share}, more than 4 "
              f"sigma ({4 * sigma}) from {rate}")
    if timed:
        pairs = allowed.sum().item() * b * h
        itemsize = 2 if bf16 else 4
        qo, kv = q.numel() * itemsize, k.numel() * itemsize
        stats = lse.numel() * 4
        mask_bytes = allowed.numel() if kind == "random" else 0
        reps = dict(reps=10, groups=3, warmup=2)
        heads = lambda x: x.transpose(1, 2)  # noqa: E731
        with torch.no_grad():
            dq, delta = fl.flash_attention_dq(q, k, v, mask, seed, got, lse,
                                              g, rate)
            plain_bwd = lambda: fl.flash_attention_backward_reference(  # noqa: E731
                q, k, v, mask, seed, got, lse, g, rate)
            rows[0]["ms"], rows[0]["plain_ms"] = in_turns(
                lambda: fl.flash_attention_forward(q, k, v, mask, seed, rate),
                lambda: fl.flash_attention_reference(q, k, v, mask, seed,
                                                     rate), **reps)
            rows[1]["ms"], rows[1]["plain_ms"] = in_turns(
                lambda: fl.flash_attention_dq(q, k, v, mask, seed, got, lse,
                                              g, rate), plain_bwd, **reps)
            rows[2]["ms"] = cuda_ms(
                lambda: fl.flash_attention_dkv(q, k, v, mask, seed, lse,
                                               delta, g, rate), **reps)
            rows[2]["plain_ms"] = rows[1]["plain_ms"]
            sdpa = lambda *x: F.scaled_dot_product_attention(  # noqa: E731
                *(heads(y) for y in x),
                attn_mask=None if mask is None else allowed, dropout_p=rate)
            rows[0]["library_ms"] = cuda_ms(lambda: sdpa(q, k, v), **reps)
            lib_err = (heads(sdpa(q, k, v)).float() - got.float()
                       ).abs().max().item() if not rate else None
            rows[0]["max_abs_diff_vs_library"] = lib_err
        lib_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*lib_leaves)
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_leaves, heads(g), retain_graph=True)
        rows[1]["library_ms"] = rows[2]["library_ms"] = cuda_ms(lib_bwd,
                                                                **reps)
        if tc:
            # The scalar kernels on the same bf16 inputs, through their C
            # entries: what the tc variant replaced.
            bufs = [torch.empty_like(x) for x in (q, lse, q, lse, k, v)]
            for i, tensors in enumerate((
                    (q, k, v, bufs[0], bufs[1]),
                    (q, k, v, g, got, lse, bufs[2], bufs[3]),
                    (q, k, v, g, lse, delta, bufs[4], bufs[5]))):
                rows[i]["scalar_ms"] = flash_scalar_ms(
                    fl, i, tensors, q, k, mask, seed, rate, **reps)
            del bufs
            # The kernels' own device time beside the host clock's: at the
            # decoder's shapes a call costs the host more than the card.
            rows[1]["library_device_ms"] = rows[2]["library_device_ms"] = (
                device_ms(lib_bwd))
            with torch.no_grad():
                rows[0]["library_device_ms"] = device_ms(lambda: sdpa(q, k,
                                                                      v))
                for row, fn in zip(rows, (
                        lambda: fl.flash_attention_forward(q, k, v, mask,
                                                           seed, rate),
                        lambda: fl.flash_attention_dq(q, k, v, mask, seed,
                                                      got, lse, g, rate),
                        lambda: fl.flash_attention_dkv(q, k, v, mask, seed,
                                                       lse, delta, g,
                                                       rate))):
                    row["device_ms"] = device_ms(fn)
        del lib_out, lib_leaves
        # The plain and the library backward compute dq, dk and dv in one.
        rows[1]["plain_and_library_cover"] = "dq + dk + dv"
        rows[2]["plain_and_library_cover"] = "dq + dk + dv"
        # Operations: 2 D flops for each product over an admitted (query,
        # key) pair: q k and p v (forward); q k, g v and ds k (dQ); q k,
        # g v, wd g and ds q (dK/dV). Bytes: each tensor once.
        rows[0].update(bound(2 * qo + 2 * kv + stats + mask_bytes,
                             4.0 * d * pairs, dtype_name(dtype)))
        rows[1].update(bound(4 * qo + 2 * kv + 2 * stats + mask_bytes,
                             6.0 * d * pairs, dtype_name(dtype)))
        rows[2].update(bound(2 * qo + 4 * kv + 2 * stats + mask_bytes,
                             8.0 * d * pairs, dtype_name(dtype)))
        for row in rows:
            row["admitted_pairs"] = pairs
    for row in rows:
        print(f"{row['kernel']} {row}", flush=True)
    return rows


def phase_flash_vit(fl, fa, prng, gen):
    """The flash attention kernels at the ViT's shape under
    vit_attention_impl "pallas" (a train step's 1,528 frames, 16 heads of
    64, unmasked), rates 0 and 0.1, with K1's tc kernels timed on the same
    q, k, v as (B, T, H*D): mhsa_short computes the same function there."""
    import torch

    rows = []
    shape = (TRAIN_FRAMES, SEQ, HEADS, WIDTH // HEADS)
    for rate in (0.0, RATE):
        tensors = [randn(shape, gen, torch.bfloat16) for _ in range(4)]
        case = flash_case(fl, prng, gen, *shape[:2], SEQ, shape[3],
                          torch.bfloat16, None, "none", rate, timed=True,
                          h=HEADS, tensors=tensors)
        flat = [x.view(TRAIN_FRAMES, SEQ, WIDTH) for x in tensors]
        seed = 4000 + SEQ if rate else None
        with torch.no_grad():
            before = (fa.mhsa_short.tc_launches,
                      fa.mhsa_short_backward.tc_launches)
            k1_fwd = cuda_ms(lambda: fa.mhsa_short(*flat[:3], seed, HEADS,
                                                   rate))
            k1_bwd = cuda_ms(lambda: fa.mhsa_short_backward(*flat, seed,
                                                            HEADS, rate))
            check(fa.mhsa_short.tc_launches > before[0]
                  and fa.mhsa_short_backward.tc_launches > before[1],
                  "K1 beside the ViT-shape flash case ran no tc kernel")
        case[0]["k1_ms"] = k1_fwd
        case[1]["k1_ms"] = case[2]["k1_ms"] = k1_bwd
        case[1]["k1_covers"] = case[2]["k1_covers"] = "dq + dk + dv"
        print(f"flash attention at the ViT's shape, rate {rate}: forward "
              f"{case[0]['ms']:.4f} ms against K1's {k1_fwd:.4f}; dQ + dK/dV "
              f"{case[1]['ms'] + case[2]['ms']:.4f} ms against K1's "
              f"{k1_bwd:.4f}", flush=True)
        rows += case
    return rows


def phase_flash(fl, fa, prng):
    """The flash attention kernels against their plain versions at the
    shapes the decoder gives them and at the ViT's, and the mask's
    properties."""
    import torch

    start = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, h, d = FLASH_SHAPE
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for kind, mask in (("causal", fl.BandMask(t, t)),
                           ("band", fl.BandMask(t, t, FLASH_WINDOW))):
            for rate in (0.0, RATE):
                rows += flash_case(fl, prng, gen, b, t, t, d, dtype, mask,
                                   kind, rate, timed=True)
    # T != S under a random general mask that admits a key in every row.
    general = torch.rand((100, t), generator=gen, device="cuda") < 0.4
    diagonal = torch.arange(100, device="cuda")
    general[diagonal, diagonal] = True
    rows += flash_case(fl, prng, gen, 4, 100, t, d, torch.bfloat16, general,
                       "random", RATE, timed=True)
    rows += flash_case(fl, prng, gen, 4, 100, t, d, torch.float32, general,
                       "random", RATE, timed=False)
    rows += flash_case(fl, prng, gen, 2, 47, 47, d, torch.bfloat16,
                       fl.BandMask(47, 47, FLASH_WINDOW), "band", RATE,
                       timed=True)
    rows += flash_case(fl, prng, gen, 2, 47, 47, 16, torch.float32,
                       fl.BandMask(47, 47), "causal", 0.0, timed=False)
    rows += flash_case(fl, prng, gen, 2, 47, 47, 16, torch.bfloat16,
                       fl.BandMask(47, 47), "causal", RATE, timed=False)
    rows += phase_flash_vit(fl, fa, prng, gen)

    # The mask's properties: rows 0-1 of a B = 8 call draw the bits of a
    # B = 2 call; another seed draws another mask; the index path equals
    # the tensor path bit for bit; two backward calls give the same bits.
    q, g = (randn(FLASH_SHAPE, gen, torch.bfloat16) for _ in range(2))
    k, v = (randn(FLASH_SHAPE, gen, torch.bfloat16) for _ in range(2))
    band = fl.BandMask(t, t, FLASH_WINDOW)
    tc_mark = fl.flash_attention_dkv.tc_launches
    with torch.no_grad():
        out, lse = fl.flash_attention_forward(q, k, v, band, 51, RATE)
        prefix = torch.equal(
            fl.flash_attention_forward(q[:2], k[:2], v[:2], band, 51,
                                       RATE)[0], out[:2])
        other = not torch.equal(
            fl.flash_attention_forward(q, k, v, band, 52, RATE)[0], out)
        first = fl.flash_attention_backward(q, k, v, band, 51, out, lse, g,
                                            RATE)
        second = fl.flash_attention_backward(q, k, v, band, 51, out, lse, g,
                                             RATE)
        as_tensor = band.tensor("cuda")
        out_t, lse_t = fl.flash_attention_forward(q, k, v, as_tensor, 51,
                                                  RATE)
        third = fl.flash_attention_backward(q, k, v, as_tensor, 51, out_t,
                                            lse_t, g, RATE)
    check(fl.flash_attention_dkv.tc_launches == tc_mark + 3,
          "the mask properties of flash attention did not run the tc "
          "kernels")
    repeat = all(torch.equal(a, b) for a, b in zip(first, second))
    index = torch.equal(out, out_t) and all(
        torch.equal(a, b) for a, b in zip(first, third))
    print(f"flash attention mask: rows 0-1 of B={b} draw the bits of B=2: "
          f"{prefix}; another seed another mask: {other}; two backward "
          f"calls give the same bits: {repeat}; the index path equals the "
          f"tensor path: {index}", flush=True)
    check(prefix and other and repeat and index,
          "flash attention's mask or its determinism failed a property")
    try:
        fl.flash_attention(*(randn((1, 4, 1, 320), gen, torch.float32)
                             for _ in range(3)))
        fail("flash_attention took D = 320 on the card")
    except ValueError:
        pass
    print(f"flash attention phase: {time.monotonic() - start:.1f} s "
          "(D = 320 raises)", flush=True)
    return rows


BLOCK_KERNELS = ("attn_block", "attn_block_bwd", "mlp_block",
                 "mlp_block_bwd")
BLOCK_DIM, BLOCK_MLP = 512, 512       # the flagship ViT: dim and mlp_dim
BLOCK_BATCHES = (TRAIN_FRAMES, 8, 1)  # a train step, a served tick, CAD encode


def block_params(gen, scale=1.0):
    """The parameters of one ViT block at the flagship's widths, seeded: each
    weight the (in, out) view of a matrix stored (out, in), as the model
    hands it to the kernels. Returns (mlp, attn) argument tuples."""
    import torch

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    lin = lambda i, o: (randn(o, i) * (scale * i ** -0.5)).t()  # noqa: E731
    vec = lambda n: randn(n) * 0.3  # noqa: E731
    d, f = BLOCK_DIM, BLOCK_MLP
    mlp = (lin(d, f), vec(f), lin(f, d), vec(d), 1 + vec(d) * 0.3, vec(d))
    attn = (lin(d, WIDTH), lin(d, WIDTH), lin(d, WIDTH), lin(WIDTH, d),
            vec(d), 1 + vec(d) * 0.3, vec(d))
    return mlp, attn


def block_close(got, want, dtype):
    """(largest error, its limit, all within?) over a tuple of tensors. The
    limit is a share of each tensor's largest entry: 2e-5 at float32 (sums
    of up to 1,024 products, and of 76,400 rows in a parameter gradient, in
    another order); 2^-6 at bf16, two bf16 units in the last place at the
    top of the range (both versions round at the same places, a sum taken
    in another order can flip such a rounding, and the output's own rounding
    can carry that to a second unit)."""
    import torch

    share = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    worst, limit, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        tol = share * max(w.float().abs().max().item(), 1e-30)
        if err > tol:
            ok = False
        if err >= worst:
            worst, limit = err, tol
    return worst, limit, ok


def block_flops(batch, name):
    """Operations of one call at the flagship's widths, 2 per multiply-add:
    what the function needs, whatever computes it."""
    t, d, f, inner = SEQ, BLOCK_DIM, BLOCK_MLP, WIDTH
    proj, core, out = 2 * t * d * inner, 2 * t * t * inner, 2 * t * inner * d
    per_frame = {
        # q, k, v; q k^T and p v; the output projection
        "attn_block": 3 * proj + 2 * core + out,
        # recompute q, k, v, q k^T, p v; da = do Wo^T; da v^T; dq, dk, dv;
        # dh from dq, dk, dv; dWo; dWq, dWk, dWv
        "attn_block_bwd": (3 * proj + 2 * core) + out + core + 3 * core
        + 3 * proj + out + 3 * proj,
        "mlp_block": 2 * t * d * f * 2,
        # recompute z; da = do W2^T; dh = dz W1^T; dW1; dW2
        "mlp_block_bwd": 2 * t * d * f * 5,
    }[name]
    return float(batch) * per_frame


def block_bytes(batch, name, itemsize):
    """Bytes of one call: x (and gy) read once, y or dx written once, the
    weights read once in the I/O dtype, the parameter gradients written once
    in float32."""
    t, d, f, inner = SEQ, BLOCK_DIM, BLOCK_MLP, WIDTH
    stream = batch * t * d * itemsize
    weights = (4 * d * inner if name.startswith("attn") else 2 * d * f)
    vectors = (3 * d if name.startswith("attn") else 3 * d + f) * 4
    if name.endswith("_bwd"):
        return 3 * stream + weights * (itemsize + 4) + 2 * vectors
    return 2 * stream + weights * itemsize + vectors


def unfused_sub_blocks(dtype):
    """The port's own unfused sub-blocks at the flagship's widths (K4 + the
    library's GEMMs + K1 + K5: vit_attention_impl "fused" with ln_impl and
    dropout_impl "pallas"), as functions of (x, rng) for the attention and
    the MLP half of one ViT block."""
    import torch
    import torch.nn.functional as F

    from videocad_tpu_torch.models.layers import active_rate
    from videocad_tpu_torch.models.vit import ViTBlock, ViTConfig
    from videocad_tpu_torch.ops.dropout import dropout

    block = ViTBlock(ViTConfig(), dtype, attention_impl="fused",
                     dropout_impl="pallas", ln_impl="pallas", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * p.shape[1] ** -0.5)

    def attn_half(x, rng):
        rate = active_rate(block, block.dropout_rate, rng)
        h = block.attn_norm(x)
        return x + dropout(block.attn(h, h, rng=rng), rng, rate, "pallas")

    def mlp_half(x, rng):
        rate = active_rate(block, block.dropout_rate, rng)
        drop = lambda y: dropout(y, rng, rate, "pallas")  # noqa: E731
        h = block.mlp_in(block.mlp_norm(x))
        return x + drop(block.mlp_out(drop(F.gelu(h))))

    return block, attn_half, mlp_half


def block_kept_sets(fb, prng, batch, dtype, rate, seed):
    """The kept set of each of the four dropout sites, read off the kernels'
    outputs under constructed parameters, against the plain versions' and
    the bit function's. Returns {site: (entries that differ from the plain
    version's set, from the bit function's)} and the drop shares."""
    import torch

    t, d, f, hd = SEQ, BLOCK_DIM, BLOCK_MLP, WIDTH // HEADS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mlp, attn = block_params(gen)
    zero = torch.zeros((batch, t, d), device="cuda", dtype=dtype)
    keep = lambda site, heads, rows, cols: prng.keep_mask(  # noqa: E731
        prng.block_site_bits(seed, site, batch, heads, rows, cols,
                             device="cuda"), rate)
    # (entries where the kernel's kept set differs from the plain version's,
    # from the bit function's)
    differ = lambda kept, plain, bits: (  # noqa: E731
        (kept != plain).sum().item(), (kept != bits).sum().item())
    same, shares = {}, {}
    with torch.no_grad():
        # Sites 1 and 3, the residual branches: with x = 0 the output is the
        # dropped branch itself, non-zero exactly where it was kept. The
        # branch's bias is set to 50, far above the product's entries (a few
        # units), so that no kept entry cancels to zero.
        offset = torch.full((d,), 50.0, device="cuda")
        attn = attn[:4] + (offset,) + attn[5:]
        mlp = mlp[:3] + (offset,) + mlp[4:]
        for site, got, want in (
                (prng.SITE_ATTN_RES,
                 fb.attn_block(zero, *attn, seed, HEADS, rate),
                 fb.attn_block_reference(zero, *attn, seed, HEADS, rate)),
                (prng.SITE_MLP_RES, fb.mlp_block(zero, *mlp, seed, rate),
                 fb.mlp_block_reference(zero, *mlp, seed, rate))):
            kept = got != 0
            same[site] = differ(kept, want != 0, keep(site, 1, t, d)[:, 0])
            shares[site] = 1.0 - kept.float().mean().item()
        # Site 2, the hidden layer: W2 = I and b2 = 0 pass the dropped hidden
        # layer through, so with x = 0 the output is non-zero where sites 2
        # and 3 both kept.
        eye = torch.eye(f, d, device="cuda")
        through = (mlp[0], mlp[1], eye, torch.zeros(d, device="cuda"),
                   mlp[4], mlp[5])
        got = fb.mlp_block(zero, *through, seed, rate)
        want = fb.mlp_block_reference(zero, *through, seed, rate)
        clean = fb.mlp_block_reference(zero, *through, None, 0.0) != 0
        both = (keep(prng.SITE_MLP_HID, 1, t, f)[:, 0]
                & keep(prng.SITE_MLP_RES, 1, t, d)[:, 0])
        same[prng.SITE_MLP_HID] = differ(got != 0, want != 0, both & clean)
        hid = keep(prng.SITE_MLP_HID, 1, t, f)
        shares[prng.SITE_MLP_HID] = 1.0 - hid.float().mean().item()
        # Site 0, the attention weights. Token j is the one-hot row e_j, so
        # LN(x)_j = rstd (e_j - 1/D) with LN scale 1 and bias 0; Wq = Wk = 0
        # make every weight 1/T; Wv puts 1/rstd at (j, head column j), so
        # the head's values are I - 1/D up to rounding and its output row i
        # is (kept_ij - n_kept_i / D) / (T (1 - rate)) at column j: above
        # half of 1 / (T (1 - rate)) where the weight (i, j) was kept,
        # below 0 where it was dropped. Wo copies 8 heads a call into the
        # 512 output columns, times 16, and site 1 drops on top.
        x = torch.zeros((batch, t, d), device="cuda", dtype=dtype)
        rows = torch.arange(t, device="cuda")
        x[:, rows, rows] = 1.0
        rstd = (1.0 / d * (1.0 - 1.0 / d) + 1e-5) ** -0.5
        wv = torch.zeros((WIDTH, d), device="cuda")
        wv.view(HEADS, hd, d)[:, rows, rows] = 1.0 / rstd
        nothing = torch.zeros((WIDTH, d), device="cuda").t()
        ones, zeros_d = (torch.ones(d, device="cuda"),
                         torch.zeros(d, device="cuda"))
        keep_w = keep(prng.SITE_ATTN_W, HEADS, t, t)
        keep_res = keep(prng.SITE_ATTN_RES, 1, t, d)[:, 0]
        level = 16.0 / (t * (1.0 - rate))
        differing = (0, 0)
        for first in (0, HEADS // 2):
            wo = torch.zeros((d, WIDTH), device="cuda")
            slots = torch.arange(HEADS // 2, device="cuda")
            cols = torch.arange(hd, device="cuda")
            wo.view(HEADS // 2, hd, HEADS, hd)[
                slots[:, None], cols[None, :], first + slots[:, None],
                cols[None, :]] = 16.0
            args = (nothing, nothing, wv.t(), wo.t(), zeros_d, ones, zeros_d)
            got = fb.attn_block(x, *args, seed, HEADS, rate).float() - x.float()
            want = fb.attn_block_reference(x, *args, seed, HEADS,
                                           rate).float() - x.float()
            kept = got.view(batch, t, HEADS // 2, hd)[..., :t] > level / 2
            plain = want.view(batch, t, HEADS // 2, hd)[..., :t] > level / 2
            bits = (keep_w[:, first:first + HEADS // 2].permute(0, 2, 1, 3)
                    & keep_res.view(batch, t, HEADS // 2, hd)[..., :t])
            differing = tuple(a + b for a, b in zip(
                differing, differ(kept, plain, bits)))
        same[prng.SITE_ATTN_W] = differing
        shares[prng.SITE_ATTN_W] = 1.0 - keep_w.float().mean().item()
    return same, shares


def block_case(fb, prng, gen, batch, dtype, rate, unfused):
    """The four fused sub-block entries at one batch, dtype and rate against
    their plain versions, timed in turns; returns their four rows."""
    import torch

    from videocad_tpu_torch.ops.dropout import DropoutRng

    f32 = dtype == torch.float32
    mlp, attn = block_params(gen)
    x, gy = (randn((batch, SEQ, BLOCK_DIM), gen, dtype) for _ in range(2))
    seed = 6000 + batch if rate else None
    label = f"B={batch} {dtype_name(dtype)} rate {rate}"
    wrappers = (fb.attn_block, fb.attn_block_backward, fb.mlp_block,
                fb.mlp_block_backward)
    marks = [w.launches for w in wrappers]

    # Through autograd, as the model calls them: one launch of each entry.
    leaves = [p.detach().clone().requires_grad_() for p in (x,) + attn + mlp]
    xx, a, m = leaves[0], leaves[1:8], leaves[8:]
    mid = fb.attn_block(xx, *a, seed, HEADS, rate)
    out = fb.mlp_block(mid, *m, seed, rate)
    grads = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    check([w.launches for w in wrappers] == [c + 1 for c in marks],
          f"fused blocks {label}: autograd did not launch each of the four "
          "entries once")
    again = torch.autograd.grad(
        fb.mlp_block(fb.attn_block(xx, *a, seed, HEADS, rate), *m, seed,
                     rate), leaves, gy)
    repeat = all(torch.equal(g1, g2) for g1, g2 in zip(grads, again))
    check(repeat, f"fused blocks {label}: two backward runs differ in a bit")

    with torch.no_grad():
        tc_marks = [w.tc_launches for w in wrappers]
        y_attn = fb.attn_block(x, *attn, seed, HEADS, rate)
        g_attn = fb.attn_block_backward(x, *attn, gy, seed, HEADS, rate)
        y_mlp = fb.mlp_block(x, *mlp, seed, rate)
        g_mlp = fb.mlp_block_backward(x, *mlp, gy, seed, rate)
        ran = ["tc" if w.tc_launches > before else "tile"
               for w, before in zip(wrappers, tc_marks)]
        checks = {
            "attn_block": block_close([y_attn], [fb.attn_block_reference(
                x, *attn, seed, HEADS, rate)], dtype),
            "attn_block_bwd": block_close(
                g_attn, fb.attn_block_backward_reference(
                    x, *attn, gy, seed, HEADS, rate), dtype),
            "mlp_block": block_close([y_mlp], [fb.mlp_block_reference(
                x, *mlp, seed, rate)], dtype),
            "mlp_block_bwd": block_close(
                g_mlp, fb.mlp_block_backward_reference(
                    x, *mlp, gy, seed, rate), dtype),
        }
    rows = {name: {"kernel": name, "batch": batch,
                   "dtype": dtype_name(dtype), "rate": rate,
                   "max_abs_err": err, "tolerance": tol,
                   "gradients_bit_equal": repeat}
            for name, (err, tol, _) in checks.items()}
    for name, (err, tol, ok) in checks.items():
        check(ok, f"fused blocks {label}: {name} max err {err} (limit {tol})")
    # bf16 takes the tensor-core variant at the flagship's widths, float32
    # the present kernels, in both sub-blocks.
    want_variant = "tile" if f32 else "tc"
    for name, variant in zip(BLOCK_KERNELS, ran):
        rows[name]["variant"] = variant
        check(variant == want_variant, f"fused blocks {label}: {name} ran "
              f"the {variant} variant, expected {want_variant}")
    if f32:
        # The whole chain's gradients against autograd through the plain
        # forwards: 1e-4 of each gradient's largest entry.
        ref = [p.detach().clone().requires_grad_() for p in leaves]
        want = torch.autograd.grad(fb.mlp_block_reference(
            fb.attn_block_reference(ref[0], *ref[1:8], seed, HEADS, rate),
            *ref[8:], seed, rate), ref, gy)
        worst = max((g - w).abs().max().item()
                    / max(w.abs().max().item(), 1e-30)
                    for g, w in zip(grads, want))
        rows["attn_block_bwd"]["rel_err_vs_autograd"] = worst
        rows["mlp_block_bwd"]["rel_err_vs_autograd"] = worst
        check(worst <= 1e-4, f"fused blocks {label}: gradients differ from "
              f"autograd through the plain forwards by {worst} of their "
              "largest entry")
    if rate:
        same, shares = block_kept_sets(fb, prng, batch, dtype, rate,
                                       7000 + batch)
        for site, name in ((prng.SITE_ATTN_W, "attn_block"),
                           (prng.SITE_ATTN_RES, "attn_block"),
                           (prng.SITE_MLP_HID, "mlp_block"),
                           (prng.SITE_MLP_RES, "mlp_block")):
            rows[name].setdefault("kept_set_identical", {})[site] = (
                same[site] == (0, 0))
            rows[name].setdefault("drop_share", {})[site] = shares[site]
            check(same[site] == (0, 0),
                  f"fused blocks {label}: the kept set of dropout site "
                  f"{site} differs from the plain version's in "
                  f"{same[site][0]} entries and from the bit function's in "
                  f"{same[site][1]}")
            cells = batch * SEQ * (HEADS * SEQ if site == prng.SITE_ATTN_W
                                   else BLOCK_DIM)
            sigma = math.sqrt(rate * (1 - rate) / cells)
            check(abs(shares[site] - rate) <= 4 * sigma + 1e-9,
                  f"fused blocks {label}: site {site} drops "
                  f"{shares[site]}, more than 4 sigma from {rate}")

    # Times: the kernel and its plain version in turns; beside them the
    # port's own unfused sub-block (forward, and forward + backward less the
    # forward) on the same x.
    reps = (dict(reps=2, groups=3, warmup=1) if batch > 64
            else dict(reps=20, groups=3, warmup=2))
    calls = {
        "attn_block": (
            lambda: fb.attn_block(x, *attn, seed, HEADS, rate),
            lambda: fb.attn_block_reference(x, *attn, seed, HEADS, rate)),
        "attn_block_bwd": (
            lambda: fb.attn_block_backward(x, *attn, gy, seed, HEADS, rate),
            lambda: fb.attn_block_backward_reference(x, *attn, gy, seed,
                                                     HEADS, rate)),
        "mlp_block": (
            lambda: fb.mlp_block(x, *mlp, seed, rate),
            lambda: fb.mlp_block_reference(x, *mlp, seed, rate)),
        "mlp_block_bwd": (
            lambda: fb.mlp_block_backward(x, *mlp, gy, seed, rate),
            lambda: fb.mlp_block_backward_reference(x, *mlp, gy, seed, rate)),
    }
    with torch.no_grad():
        for name, (kernel, plain) in calls.items():
            rows[name]["ms"], rows[name]["plain_ms"] = in_turns(kernel, plain,
                                                                **reps)
        if not f32:
            # The present kernels ("tile") on the same bf16 inputs: what the
            # tc variant replaced at these shapes.
            tile = {"attn_block": lambda: fb._attn_forward(
                        x, *attn, seed, HEADS, rate, 1e-5, variant="tile"),
                    "attn_block_bwd": lambda: fb._attn_backward(
                        x, *attn, gy, seed, HEADS, rate, 1e-5,
                        variant="tile"),
                    "mlp_block": lambda: fb._mlp_forward(
                        x, *mlp, seed, rate, 1e-5, variant="tile"),
                    "mlp_block_bwd": lambda: fb._mlp_backward(
                        x, *mlp, gy, seed, rate, 1e-5, variant="tile")}
            for name, run in tile.items():
                rows[name]["tile_ms"] = cuda_ms(run, **reps)
                rows[name]["tile_device_ms"] = device_ms(run, 5)
            for name in BLOCK_KERNELS:
                rows[name]["device_ms"] = device_ms(calls[name][0], 5)
            for name in ("attn_block_bwd", "mlp_block_bwd"):
                rows[name]["pieces"] = block_pieces(calls[name][0])
    block, attn_half, mlp_half = unfused
    block.train(rate > 0)
    rng = DropoutRng(5, "cuda") if rate else None
    xg = x.detach().clone().requires_grad_()
    for half, fwd_name in ((attn_half, "attn_block"), (mlp_half, "mlp_block")):
        fwd_run = lambda: half(x, rng)  # noqa: E731
        params = [xg] + list(block.parameters())
        both_run = lambda: torch.autograd.grad(  # noqa: E731
            half(xg, rng), params, gy, allow_unused=True)
        with torch.no_grad():
            fwd = cuda_ms(fwd_run, **reps)
        both = cuda_ms(both_run, **reps)
        rows[fwd_name]["unfused_ms"] = fwd
        rows[fwd_name + "_bwd"]["unfused_ms"] = both - fwd
        if not f32:
            with torch.no_grad():
                fwd_dev = device_ms(fwd_run, 5)
            rows[fwd_name]["unfused_device_ms"] = fwd_dev
            rows[fwd_name + "_bwd"]["unfused_device_ms"] = (
                device_ms(both_run, 5) - fwd_dev)
    itemsize = 4 if f32 else 2
    for name, row in rows.items():
        row["library_ms"] = None
        row.update(bound(block_bytes(batch, name, itemsize),
                         block_flops(batch, name), dtype_name(dtype)))
        print(f"{name} {row}", flush=True)
    return list(rows.values())


def block_pieces(run):
    """The device time of one backward call of a sub-block by piece
    (torch.profiler; cli/block_cost.py's grouping): the sub-block kernel,
    the weight-gradient products (dWo; dW1 and dW2), their partial sums,
    the partial rows' sums, and the rest (torch.matmul's GEMM for dWqkv,
    the casts)."""
    from videocad_tpu_torch.cli.block_cost import pieces_of
    from videocad_tpu_torch.cli.profile import profile_work

    return pieces_of(profile_work("", run, 5, top_n=24)["top"])


def ptxas_usage(log, kernel):
    """Registers and spill bytes of ``kernel`` (a substring of its mangled
    name) from nvcc's -Xptxas -v output."""
    usage, inside = {}, False
    for line in log.splitlines():
        if ("Compiling entry function" in line
                or "Function properties for" in line):
            inside = kernel in line
        elif inside and "spill stores" in line:
            words = line.replace(",", "").split()
            usage["spill_stores"] = int(words[words.index("spill") - 2])
            usage["spill_loads"] = int(words[words.index("loads") - 3])
        elif inside and "Used" in line and "registers" in line:
            usage["registers"] = int(line.split("Used")[1].split()[0])
            inside = False
    return usage


def phase_block(fb, prng):
    """The fused ViT sub-block kernels (attention and MLP, forward and
    backward) against their plain versions at the flagship's widths: a
    train step's 1,528 frames, a served tick's 8, the CAD encode's 1; bf16
    and float32; dropout off and on."""
    import torch

    start = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        unfused = unfused_sub_blocks(dtype)
        for batch in BLOCK_BATCHES:
            for rate in (0.0, RATE):
                rows += block_case(fb, prng, gen, batch, dtype, rate, unfused)
                torch.cuda.empty_cache()
    x = randn((2, SEQ + 15, BLOCK_DIM), gen, torch.float32)
    mlp, attn = block_params(gen)
    try:
        fb.attn_block(x, *attn, None, HEADS)
        fail("attn_block took T = 65 on the card")
    except ValueError:
        pass
    print(f"fused block phase: {time.monotonic() - start:.1f} s (T = 65 "
          "raises)", flush=True)
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


def to_card(batch):
    import torch

    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def phase_train_a(fa):
    """Phase 6: the flagship's train step as its JSON has it, on the card."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_eval_step,
                                          make_train_step)

    torch.cuda.reset_peak_memory_stats()
    model = create_model(flagship_config(), device="cuda",
                         generator=torch.Generator().manual_seed(0))
    cfg = model.config
    check(cfg.dtype == "bfloat16" and cfg.dropout == RATE
          and cfg.vit_attention_impl == "fused"
          and cfg.preprocess_impl == "xla",
          f"the flagship config changed: {cfg}")
    loss_config = LossConfig(REFERENCE_CMD_WEIGHTS)
    state = create_train_state(dict(model.named_parameters()),
                               {"lr": 1e-5})
    train_step = make_train_step(model, loss_config)
    eval_step = make_eval_step(model, loss_config)
    batch_size = TRAIN_BATCH
    while True:
        batch = to_card(synthetic_batch_feed(batch_size, TRAIN_SEQ,
                                             image_size=224, seed=0))
        eval_before = eval_step(batch)[0].item()
        losses, step_ms = [], []
        for step in range(4):
            marks = (fa.mhsa_short.launches, fa.mhsa_short_backward.launches,
                     fa.mhsa_short.tc_launches,
                     fa.mhsa_short_backward.tc_launches)
            torch.cuda.synchronize()
            start = time.monotonic()
            state, loss, metrics = train_step(state, batch, 0)
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - start) * 1e3)
            losses.append(loss.item())
            fwd = fa.mhsa_short.launches - marks[0]
            bwd = fa.mhsa_short_backward.launches - marks[1]
            tc = (fa.mhsa_short.tc_launches - marks[2],
                  fa.mhsa_short_backward.tc_launches - marks[3])
            check(fwd == 12 and bwd == 12 and tc == (12, 12),
                  f"train step {step}: {fwd} forward and {bwd} backward "
                  f"launches of mhsa_short, {tc} of its tensor-core "
                  "variant, expected 12 and 12 of it")
        if max(step_ms[1:]) <= 10e3 or batch_size == 1:
            break
        batch_size //= 2        # too slow: halve B, keep T and the widths
        print(f"train A: a step took {max(step_ms[1:]):.0f} ms; B halved to "
              f"{batch_size}", flush=True)
    eval_after = eval_step(batch)[0].item()
    check(state.step >= 4 and all(math.isfinite(x) for x in losses),
          f"train A losses {losses}")
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    check(len(grads) == len(state.params), "a parameter got no gradient")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "a gradient is not finite")
    check(grads["state_encoder.block_0.attn.query.weight"].abs().max().item()
          > 0, "state_encoder.block_0.attn.query.weight has a zero gradient")
    timed = step_ms[1:]
    ms = statistics.mean(timed)
    frames = batch_size * (TRAIN_SEQ - 1)
    print(f"train A: flagship bf16 dropout {RATE}, B={batch_size} "
          f"T={TRAIN_SEQ}; losses {[round(x, 4) for x in losses]}; eval loss "
          f"{eval_before:.5f} -> {eval_after:.5f}; step ms {timed} (mean "
          f"{ms:.1f}, {frames / ms * 1e3:.0f} frames/s); mhsa_short launches "
          f"per step 12 forward + 12 backward, all tensor-core; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; total "
          f"predictions {metrics['total_predictions'].item():.0f}",
          flush=True)
    check(eval_after < eval_before,
          f"the eval loss did not fall: {eval_before} -> {eval_after}")
    return {"batch": batch_size, "step_ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train_b(pp):
    """Phase 7: the same config with the fused preprocess kernels."""
    import numpy as np
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_eval_step,
                                          make_train_step)

    cfg = dict(flagship_config(), preprocess_impl="pallas")
    model = create_model(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    loss_config = LossConfig(REFERENCE_CMD_WEIGHTS)
    state = create_train_state(dict(model.named_parameters()),
                               {"lr": 1e-5})
    data = synthetic_batch_feed(2, 48, image_size=224, seed=1)
    data["cad_image"] = np.random.default_rng(2).integers(
        0, 256, (2, 256, 256, 3), dtype=np.uint8)
    batch = to_card(data)
    fused = pp.grayscale_normalize_fused
    marks = (fused.launches, fused.resize_launches)
    train_step = make_train_step(model, loss_config)
    losses = []
    for _ in range(2):
        state, loss, _ = train_step(state, batch, 1)
        losses.append(loss.item())
    eval_fused = make_eval_step(model, loss_config)(batch)[0].item()
    plain_launches = fused.launches - marks[0]
    resize_launches = fused.resize_launches - marks[1]
    # The same weights and batch through the plain preprocess path.
    plain_model = create_model(dict(cfg, preprocess_impl="xla"),
                               device="cuda")
    plain_model.load_state_dict(model.state_dict())
    eval_plain = make_eval_step(plain_model, loss_config)(batch)[0].item()
    print(f"train B: preprocess_impl pallas, B=2 T=48, CAD 256x256; losses "
          f"{[round(x, 4) for x in losses]}; eval loss {eval_fused:.5f} "
          f"(plain preprocess {eval_plain:.5f}); gray_normalize launches "
          f"{plain_launches}, gray_resize_normalize launches "
          f"{resize_launches}", flush=True)
    check(all(math.isfinite(x) for x in losses + [eval_fused]),
          f"train B losses {losses}, eval {eval_fused}")
    check(plain_launches == 3 and resize_launches == 3,
          f"train B launched gray_normalize {plain_launches} times and "
          f"gray_resize_normalize {resize_launches} times, expected 3 and 3")
    check(abs(eval_fused - eval_plain) <= 1e-2 * abs(eval_plain),
          f"eval loss {eval_fused} under the fused preprocess, {eval_plain} "
          "under the plain one")


TRAIN_C_FILES = (
    "params.json", "training_config.json", "results.json", "seq_results.json",
    "epoch_1.json", "epoch_2.json", "val_epoch_1.json", "val_epoch_2.json",
    "val_seq.json", "test.json", "test_seq.json")


def mean_eval_loss(model, pipe, loss_config):
    """The mean teacher-forced eval loss of ``model`` over ``pipe``."""
    import torch

    from videocad_tpu_torch.train import make_eval_step

    step = make_eval_step(model, loss_config)
    losses = [step({k: torch.from_numpy(v).cuda() for k, v in batch.items()
                    if k != "ids"})[0].item() for batch in pipe.epoch(0)]
    check(len(losses) > 0, "the test split gave no batch")
    return statistics.mean(losses)


# What torch.cuda.set_sync_debug_mode("warn") says of a host synchronisation.
SYNC_WARNING = "called a synchronizing CUDA operation"


class EpochWatch:
    """Instruments ``Trainer`` for the smoke run: every host
    synchronisation inside ``_train_epoch`` other than the logging fetch
    (``_snapshot``) is recorded (``torch.cuda.set_sync_debug_mode("warn")``
    turns each into a warning), and the epochs' wall time, steps and kernel
    launches are summed; ``resume`` records where a resumed run starts, and
    the checkpoint handler's ``save`` is timed."""

    def __init__(self, trainer_cls, handler_cls, counters):
        self.cls, self.handler_cls = trainer_cls, handler_cls
        self.counters = counters
        self.syncs, self.epochs, self.resumed = [], [], None
        self.save_seconds = []
        self.saved = (trainer_cls._train_epoch, trainer_cls._snapshot,
                      trainer_cls.resume, handler_cls.save)

    def __enter__(self):
        import torch

        epoch, snapshot, resume, save = self.saved
        watch = self
        # The detector itself, first: a deliberate synchronisation must
        # raise the warning the epochs are searched for.
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device="cuda").item()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(any(SYNC_WARNING in str(w.message) for w in caught),
              "torch's sync debug mode did not report a deliberate .item(): "
              f"{[str(w.message) for w in caught]}")

        def watched_epoch(trainer, *args, **kw):
            marks = {k: read() for k, read in watch.counters.items()}
            torch.cuda.synchronize()
            start = time.monotonic()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = epoch(trainer, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            watch.syncs += [f"{w.filename}:{w.lineno}: {w.message}"
                            for w in caught if SYNC_WARNING in str(w.message)]
            watch.epochs.append({
                "seconds": time.monotonic() - start,
                "steps": len(trainer.train_pipe),
                "launches": {k: read() - marks[k]
                             for k, read in watch.counters.items()}})
            return out

        def watched_snapshot(trainer, *args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return snapshot(trainer, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        def watched_resume(trainer, *args, **kw):
            found = resume(trainer, *args, **kw)
            watch.resumed = {
                "found": found, "start_epoch": trainer.start_epoch,
                "step": trainer.state.step,
                "params": {k: p.detach().cpu().clone()
                           for k, p in trainer.state.params.items()}}
            return found

        def watched_save(handler, *args, **kw):
            start = time.monotonic()
            path = save(handler, *args, **kw)
            watch.save_seconds.append(time.monotonic() - start)
            return path

        self.cls._train_epoch = watched_epoch
        self.cls._snapshot = watched_snapshot
        self.cls.resume = watched_resume
        self.handler_cls.save = watched_save
        return self

    def __exit__(self, *exc):
        (self.cls._train_epoch, self.cls._snapshot, self.cls.resume,
         self.handler_cls.save) = self.saved


def phase_train_c(counters, card, root):
    """Phase 8: the training entry point end to end, and phase 9, serving
    from its checkpoint, under the scratch directory ``root``. Returns the
    launches of the path per kernel and the arguments that name the
    dataset it wrote, for the phases that reuse it."""
    import torch

    from videocad_tpu_torch.cli import train as cli_train
    from videocad_tpu_torch.data.pipeline import device_prefetch
    from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
    from videocad_tpu_torch.experiment import default_loss_config
    from videocad_tpu_torch.models.factory import (FLAGSHIP_NAME,
                                                   create_model,
                                                   flagship_config)
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    from videocad_tpu_torch.train.trainer import Trainer

    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    split_path = os.path.join(data_dir, "dataset_split.json")
    start = time.monotonic()
    split = write_synthetic_dataset(
        data_dir, num_sequences=32, min_len=150, max_len=191,
        image_size=224, seed=0, split_path=split_path)
    sizes = [sum(1 for v in split.values() if v == name)
             for name in ("train", "val", "test")]
    print(f"train C: dataset written in {time.monotonic() - start:.1f} s "
          f"(train / val / test sequences {sizes})", flush=True)
    check(sizes == [16, 8, 8], f"split sizes {sizes}")

    name = FLAGSHIP_NAME + "_pallas_ln_dropout"
    params = dict(flagship_config(), ln_impl="pallas",
                  dropout_impl="pallas")
    params["train_config"] = {
        "experiment_name": "train_c", "save_frequency": 1,
        "val_frequency": 1, "seq_val_frequency": 2, "log_frequency": 2,
        "sequential": True}
    config_path = os.path.join(root, "model_config.json")
    with open(config_path, "w") as f:
        json.dump({name: params}, f)
    argv = ["--dataset_path", data_dir, "--config_path", split_path,
            "--model_config", config_path, "--model_name", name,
            "--device", "cuda", "--batch_size", str(TRAIN_BATCH),
            "--lr", "1e-5", "--no_enable_random",
            "--checkpoint_dir", os.path.join(root, "checkpoints"),
            "--log_dir", os.path.join(root, "logs"),
            "--class_weights", os.path.join(root, "no_class_weights")]

    # The eval loss of the untrained weights on the test split: the
    # experiment initialises its model from the same seed.
    args = cli_train.parse_args(argv)
    pipes = cli_train.build_pipelines(args, [], params)
    test_pipe = pipes["test"]

    # The host pipeline and the device feed alone, without a model: the
    # seconds to assemble a batch (unpickle, pad, stack) and to pin and
    # copy it to the card.
    start = time.monotonic()
    host_batches = list(pipes["train"].epoch(0))
    assemble_s = (time.monotonic() - start) / len(host_batches)
    torch.cuda.synchronize()
    start = time.monotonic()
    for fed in device_prefetch(iter(host_batches), "cuda", size=2):
        check(fed["frames"].shape == (TRAIN_BATCH, TRAIN_SEQ, 224, 224, 3),
              f"a fed batch of shape {tuple(fed['frames'].shape)}")
    torch.cuda.synchronize()
    feed_s = (time.monotonic() - start) / len(host_batches)
    batch_mb = sum(v.nbytes for v in host_batches[0].values()
                   if hasattr(v, "nbytes")) / 1e6
    del host_batches, fed
    loss_config = default_loss_config({})
    model = create_model(params, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    loss_before = mean_eval_loss(model, test_pipe, loss_config)

    for reset in counters.values():
        reset(0)                      # train C's path starts here
    torch.cuda.reset_peak_memory_stats()
    start = time.monotonic()
    with EpochWatch(Trainer, CheckpointHandler, counters) as watch:
        results = cli_train.main(argv + ["--epochs", "2"])
        first_seconds = time.monotonic() - start
        check(watch.resumed is None, "the first run resumed")
        start = time.monotonic()
        resumed_results = cli_train.main(
            argv + ["--epochs", "3", "--resume"])
        second_seconds = time.monotonic() - start
    launches = {k: read() for k, read in counters.items()}  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(not watch.syncs, "the epoch loop synchronised the host outside "
          "its logging fetch:\n" + "\n".join(watch.syncs[:10]))
    log_dir = os.path.join(root, "logs", "train_c")
    for file_name in TRAIN_C_FILES + ("epoch_3.json",):
        path = os.path.join(log_dir, file_name)
        check(os.path.isfile(path), f"train C wrote no {file_name}")
        with open(path) as f:
            json.load(f)
    for result in (results, resumed_results):
        check(result["total_predictions"] > 0
              and math.isfinite(result["overall_accuracy"]),
              f"test results {result}")
    handler = CheckpointHandler("train_c",
                                os.path.join(root, "checkpoints"))
    check(handler.latest_epoch() == "epoch_3",
          f"latest checkpoint {handler.latest_epoch()}")
    check(len(watch.epochs) == 3 and all(e["steps"] == 2
                                         for e in watch.epochs),
          f"epochs run: {watch.epochs}")
    saved = torch.load(os.path.join(handler.base, "epoch_2", "state.pt"),
                       map_location="cpu", weights_only=True)
    resumed = watch.resumed
    check(resumed is not None and resumed["found"]
          and resumed["start_epoch"] == 2 and resumed["step"] == 4
          and saved["step"] == 4,
          f"the resumed run started at {resumed and resumed['start_epoch']}"
          f", step {resumed and resumed['step']}")
    check(all(torch.equal(resumed["params"][k], v)
              for k, v in saved["params"].items()),
          "the resumed parameters are not the checkpoint's")
    moments = saved["opt_state"]["state"]
    check(len(moments) == len(saved["params"])
          and all(float(m["step"]) == 4 for m in moments.values()),
          "the checkpoint lacks Adam's moments or step counts")

    handler.restore_params("epoch_3", dict(model.named_parameters()))
    loss_after = mean_eval_loss(model, test_pipe, loss_config)
    per_step = {k: [e["launches"][k] / e["steps"] for e in watch.epochs]
                for k in counters}
    step_ms = [e["seconds"] / e["steps"] * 1e3 for e in watch.epochs]
    print(f"train C: cli.train.main, flagship bf16 with ln_impl and "
          f"dropout_impl pallas, B={TRAIN_BATCH}, bucket 192, on {card}: "
          f"2 epochs in {first_seconds:.1f} s, resume + 1 epoch in "
          f"{second_seconds:.1f} s; ms per step by epoch (host clock "
          f"around the epoch, data loading included) "
          f"{[round(x, 1) for x in step_ms]}; launches per train step by "
          f"epoch {per_step}; launches of the whole path {launches}; "
          f"host pipeline alone {assemble_s:.3f} s per batch of "
          f"{batch_mb:.0f} MB assembled (2 threads), {feed_s:.3f} s per "
          f"batch pinned and copied to the card; checkpoint saves "
          f"{[round(x, 2) for x in watch.save_seconds]} s; "
          f"peak memory {peak_gb:.2f} GB; test eval loss "
          f"{loss_before:.5f} -> {loss_after:.5f}; test accuracy "
          f"{resumed_results['overall_accuracy']:.2f}%; host syncs in "
          f"the epoch loops outside the logging fetch: "
          f"{len(watch.syncs)}", flush=True)
    check(math.isfinite(loss_after) and loss_after < loss_before,
          f"the test eval loss did not fall: {loss_before} -> "
          f"{loss_after}")
    for kernel in ("layer_norm_fwd", "layer_norm_bwd", "hw_dropout",
                   "mhsa_short", "mhsa_short_bwd"):
        check(min(per_step[kernel]) > 0,
              f"train C's steps launched no {kernel} kernel")
    del model
    torch.cuda.empty_cache()
    phase_serve_checkpoint(config_path, name,
                           os.path.join(handler.base, "epoch_3"))
    return launches, ["--dataset_path", data_dir, "--config_path", split_path]


def phase_serve_checkpoint(config_path, name, checkpoint):
    """Phase 9: the serving CLI's engine from a trainer checkpoint, one
    session of a few steps behind the HTTP server."""
    import numpy as np

    from videocad_tpu_torch.cli.serve import build_engine, parse_args
    from videocad_tpu_torch.infer.server import ServingClient, make_server

    engine = build_engine(parse_args([
        "--device", "cuda", "--lanes", "2", "--seq_len", str(SEQ_LEN),
        "--model_config", config_path, "--model_name", name,
        "--checkpoint_folder", checkpoint]))
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        rng = np.random.default_rng(5)
        sid = client.open_session(
            rng.integers(0, 256, (224, 224, 3), dtype=np.uint8))
        replies = [client.step(sid, rng.integers(0, 256, (224, 224, 3),
                                                 dtype=np.uint8))
                   for _ in range(3)]
        client.close_session(sid)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    for s, reply in enumerate(replies):
        check(valid_reply(reply, s), f"checkpoint serve step {s}: {reply}")
    print(f"serve from checkpoint: {os.path.basename(checkpoint)} answered 3 "
          f"steps, cmds {[r['cmd'] for r in replies]}", flush=True)


ALL_PALLAS = {"attention_impl": "pallas", "ln_impl": "pallas",
              "dropout_impl": "pallas"}


def phase_train_d(counters, card, root, dataset_argv):
    """Phase 10: the training entry point with the decoder's attention
    through the flash attention kernels, on train C's dataset. Returns the
    launches of the path per kernel and the arguments that name the model
    and its checkpoints, for the evaluation."""
    import torch

    from videocad_tpu_torch.cli import train as cli_train
    from videocad_tpu_torch.models.factory import (FLAGSHIP_NAME,
                                                   flagship_config)
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    from videocad_tpu_torch.train.trainer import Trainer

    name = FLAGSHIP_NAME + "_pallas_attention_ln_dropout"
    params = dict(flagship_config(), **ALL_PALLAS)
    params["train_config"] = {
        "experiment_name": "train_d", "save_frequency": 1,
        "val_frequency": 1, "log_frequency": 2}
    config_path = os.path.join(root, "model_config_d.json")
    with open(config_path, "w") as f:
        json.dump({name: params}, f)
    model_argv = ["--model_config", config_path, "--model_name", name,
                  "--device", "cuda", "--batch_size", str(TRAIN_BATCH),
                  "--checkpoint_dir", os.path.join(root, "checkpoints"),
                  "--class_weights", os.path.join(root, "no_class_weights")]
    argv = dataset_argv + model_argv + [
        "--lr", "1e-5", "--no_enable_random", "--epochs", "1",
        "--log_dir", os.path.join(root, "logs")]

    for reset in counters.values():
        reset(0)                          # train D's path starts here
    torch.cuda.reset_peak_memory_stats()
    start = time.monotonic()
    with EpochWatch(Trainer, CheckpointHandler, counters) as watch:
        results = cli_train.main(argv)
    seconds = time.monotonic() - start
    launches = {k: read() for k, read in counters.items()}  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(not watch.syncs, "train D's epoch loop synchronised the host "
          "outside its logging fetch:\n" + "\n".join(watch.syncs[:10]))
    check(len(watch.epochs) == 1 and watch.epochs[0]["steps"] == 2,
          f"train D's epochs: {watch.epochs}")
    for file_name in ("params.json", "epoch_1.json", "val_epoch_1.json",
                      "test.json", "results.json"):
        check(os.path.isfile(os.path.join(root, "logs", "train_d",
                                          file_name)),
              f"train D wrote no {file_name}")
    handler = CheckpointHandler("train_d", os.path.join(root, "checkpoints"))
    for checkpoint in ("epoch_1", "best_model"):
        check(os.path.isfile(os.path.join(handler.base, checkpoint,
                                          "state.pt")),
              f"train D saved no {checkpoint}")
    check(results["total_predictions"] > 0
          and math.isfinite(results["overall_accuracy"]),
          f"train D's test results {results}")
    epoch = watch.epochs[0]
    per_step = {k: epoch["launches"][k] / epoch["steps"] for k in counters}
    print(f"train D: cli.train.main, flagship bf16 with attention_impl, "
          f"ln_impl and dropout_impl pallas, B={TRAIN_BATCH}, bucket 192, on "
          f"{card}: 1 epoch of 2 steps, validation, 2 checkpoints and the "
          f"test evaluation in {seconds:.1f} s; "
          f"{epoch['seconds'] / epoch['steps'] * 1e3:.1f} ms per step (host "
          f"clock around the epoch, data loading included); launches per "
          f"train step {per_step}; launches of the whole path {launches}; "
          f"peak memory {peak_gb:.2f} GB; test accuracy "
          f"{results['overall_accuracy']:.2f}%; host syncs in the epoch "
          f"loop outside the logging fetch: {len(watch.syncs)}", flush=True)
    for kernel in FLASH_KERNELS:
        check(per_step[kernel] == per_step[kernel + "_tc"] == 16,
              f"a train step of train D launched {kernel} "
              f"{per_step[kernel]} times, {per_step[kernel + '_tc']} of them "
              "of the tc variant, expected 16 of it (8 layers x self and "
              "cross attention)")
    # One train step's 16 forward launches, and 16 more for each
    # teacher-forced evaluation batch (validation and test: one of 8 each).
    check(launches["flash_attention"] == 2 * 16 + 2 * 16,
          f"train D launched the flash forward "
          f"{launches['flash_attention']} times, expected 64")
    for kernel in ("layer_norm_fwd", "layer_norm_bwd", "hw_dropout",
                   "mhsa_short", "mhsa_short_bwd"):
        check(per_step[kernel] > 0,
              f"train D's steps launched no {kernel} kernel")
    return launches, model_argv, peak_gb


BLOCK = dict(ALL_PALLAS, vit_attention_impl="block")


def phase_train_e(counters, card, root, dataset_argv, peak_d_gb):
    """Phase 12: the training entry point with the ViT through the fused
    sub-block kernels (its memory mode), on train C's dataset. Returns the
    launches of the path per kernel."""
    import torch

    from videocad_tpu_torch.cli import train as cli_train
    from videocad_tpu_torch.models.factory import (FLAGSHIP_NAME,
                                                   flagship_config)
    from videocad_tpu_torch.models.videocadformer import VideoCADFormerConfig
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    from videocad_tpu_torch.train.trainer import Trainer

    name = FLAGSHIP_NAME + "_vit_block"
    params = dict(flagship_config(), **BLOCK)
    params["train_config"] = {
        "experiment_name": "train_e", "save_frequency": 1,
        "val_frequency": 1, "log_frequency": 2}
    config_path = os.path.join(root, "model_config_e.json")
    with open(config_path, "w") as f:
        json.dump({name: params}, f)
    argv = dataset_argv + [
        "--model_config", config_path, "--model_name", name,
        "--device", "cuda", "--batch_size", str(TRAIN_BATCH),
        "--checkpoint_dir", os.path.join(root, "checkpoints"),
        "--class_weights", os.path.join(root, "no_class_weights"),
        "--lr", "1e-5", "--no_enable_random", "--epochs", "1",
        "--log_dir", os.path.join(root, "logs")]

    for reset in counters.values():
        reset(0)                          # train E's path starts here
    torch.cuda.reset_peak_memory_stats()
    start = time.monotonic()
    with EpochWatch(Trainer, CheckpointHandler, counters) as watch:
        results = cli_train.main(argv)
    seconds = time.monotonic() - start
    launches = {k: read() for k, read in counters.items()}  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(not watch.syncs, "train E's epoch loop synchronised the host "
          "outside its logging fetch:\n" + "\n".join(watch.syncs[:10]))
    check(len(watch.epochs) == 1 and watch.epochs[0]["steps"] == 2,
          f"train E's epochs: {watch.epochs}")
    for file_name in ("params.json", "epoch_1.json", "val_epoch_1.json",
                      "test.json", "results.json"):
        check(os.path.isfile(os.path.join(root, "logs", "train_e",
                                          file_name)),
              f"train E wrote no {file_name}")
    handler = CheckpointHandler("train_e", os.path.join(root, "checkpoints"))
    for checkpoint in ("epoch_1", "best_model"):
        check(os.path.isfile(os.path.join(handler.base, checkpoint,
                                          "state.pt")),
              f"train E saved no {checkpoint}")
    check(results["total_predictions"] > 0
          and math.isfinite(results["overall_accuracy"]),
          f"train E's test results {results}")
    epoch = watch.epochs[0]
    per_step = {k: epoch["launches"][k] / epoch["steps"] for k in counters}
    print(f"train E: cli.train.main, flagship bf16 with vit_attention_impl "
          f"block and attention_impl, ln_impl and dropout_impl pallas, "
          f"B={TRAIN_BATCH}, bucket 192, on {card}: 1 epoch of 2 steps, "
          f"validation, 2 checkpoints and the test evaluation in "
          f"{seconds:.1f} s; "
          f"{epoch['seconds'] / epoch['steps'] * 1e3:.1f} ms per step (host "
          f"clock around the epoch, data loading included); launches per "
          f"train step {per_step}; launches of the whole path {launches}; "
          f"peak memory {peak_gb:.2f} GB against train D's "
          f"{peak_d_gb:.2f} GB; test accuracy "
          f"{results['overall_accuracy']:.2f}%; host syncs in the epoch "
          f"loop outside the logging fetch: {len(watch.syncs)}", flush=True)
    depth = VideoCADFormerConfig.from_json(flagship_config()).vit_depth
    for kernel in BLOCK_KERNELS:
        # Two encoders (the frames' and the CAD image's) of 6 blocks each.
        check(per_step[kernel] == 2 * depth,
              f"a train step of train E launched {kernel} "
              f"{per_step[kernel]} times, expected {2 * depth} ({depth} "
              "blocks x 2 encoders)")
    # Two train steps, and one forward each for the validation and the test
    # batch.
    for kernel, passes in (("attn_block", 4), ("mlp_block", 4),
                           ("attn_block_bwd", 2), ("mlp_block_bwd", 2)):
        check(launches[kernel] == passes * 2 * depth,
              f"train E launched {kernel} {launches[kernel]} times, expected "
              f"{passes * 2 * depth}")
    check(launches["mhsa_short"] == 0 and launches["mhsa_short_bwd"] == 0,
          "train E launched the short-sequence attention kernels, which "
          "the fused sub-blocks replace")
    for kernel in BLOCK_KERNELS:
        check(launches[kernel + "_tc"] == launches[kernel],
              f"train E launched {kernel} {launches[kernel]} times, "
              f"{launches[kernel + '_tc']} of them the tensor-core variant")
    for kernel in FLASH_KERNELS + ("layer_norm_fwd", "layer_norm_bwd",
                                   "hw_dropout"):
        check(per_step[kernel] > 0,
              f"train E's steps launched no {kernel} kernel")
    check(peak_gb < peak_d_gb,
          f"train E's peak memory {peak_gb:.2f} GB is not below train D's "
          f"{peak_d_gb:.2f} GB")
    return launches


def phase_evaluate(counters, root, dataset_argv, model_argv):
    """Phase 11: the evaluation entry point on train D's best_model."""
    import csv

    import torch

    from videocad_tpu_torch.cli import evaluate as cli_evaluate
    from videocad_tpu_torch.data.dataset import load_split_ids

    out_root = os.path.join(root, "evaluate")
    for reset in counters.values():
        reset(0)                          # the evaluation's path starts here
    start = time.monotonic()
    results = cli_evaluate.main(dataset_argv + model_argv + [
        "--checkpoint_folder", "train_d", "--output_root_dir", out_root,
        "--sequential"])
    torch.cuda.synchronize()
    seconds = time.monotonic() - start
    launches = {k: read() for k, read in counters.items()}  # and ends here

    splits = load_split_ids(dataset_argv[3])
    samples = os.path.join(out_root, "train_d", "samples")
    for sample_id in splits["test"]:
        for stem in ("pred_actions_{}.csv", "actions_{}.csv",
                     "images_{}.png"):
            check(os.path.isfile(os.path.join(samples,
                                              stem.format(sample_id))),
                  f"the evaluation wrote no {stem.format(sample_id)}")
    with open(os.path.join(samples,
                           f"pred_actions_{splits['test'][0]}.csv")) as f:
        predicted = list(csv.reader(f))
    check(len(predicted) == TRAIN_SEQ - 1 and len(predicted[0]) == 7,
          f"a prediction CSV of {len(predicted)} rows")
    for mode in ("val", "test"):
        data = results["first_mistakes"][mode]
        check(len(data) == 10, f"{len(data)} tolerance levels for {mode}")
        for bucket in data:
            check(len(bucket["Sequence Lengths"]) == len(splits[mode])
                  and len(bucket["Number of Mistakes"]) == len(splits[mode]),
                  f"the first-mistake structure of {mode} holds "
                  f"{len(bucket['Sequence Lengths'])} sequences, not "
                  f"{len(splits[mode])}")
        metrics = results[mode]
        check(metrics["total_predictions"] > 0
              and all(math.isfinite(v) for v in metrics.values()
                      if isinstance(v, float)),
              f"the {mode} metrics: {metrics}")
    check(results["test_seq"]["total_predictions"] > 0
          and math.isfinite(results["test_seq"]["overall_accuracy"]),
          f"the rollout metrics: {results['test_seq']}")
    plots_dir = os.path.join(out_root, "train_d", "plots")
    plot_files = [n for n in os.listdir(plots_dir) if n.endswith(".png")]
    if results["plots"]:
        # Per split: 4 sequence plots, 7 confusion matrices, 2 curves.
        check(len(plot_files) == 26, f"{len(plot_files)} plot files, not 26")
    else:
        check(not plot_files, "plot files without matplotlib")
    print(f"evaluate: cli.evaluate.main on train D's best_model in "
          f"{seconds:.1f} s; matplotlib installed: {results['plots']} "
          f"({len(plot_files)} plot files); {len(splits['test'])} test "
          f"samples written; first-mistake data for {len(splits['val'])} val "
          f"and {len(splits['test'])} test sequences at 10 tolerances; "
          f"accuracy val {results['val']['overall_accuracy']:.2f}% test "
          f"{results['test']['overall_accuracy']:.2f}% rollout "
          f"{results['test_seq']['overall_accuracy']:.2f}%; launches "
          f"{launches}", flush=True)
    # Five teacher-forced passes (sample, two first-mistake passes, two
    # evaluations), each one batch of 8: 16 forward launches a pass.
    check(launches["flash_attention"] == launches["flash_attention_tc"]
          == 5 * 16,
          f"the evaluation launched the flash forward "
          f"{launches['flash_attention']} times, "
          f"{launches['flash_attention_tc']} of the tc variant, expected 80 "
          "of it")
    check(launches["flash_attention_dq"] == 0
          and launches["flash_attention_dkv"] == 0,
          "the evaluation launched a backward kernel")
    return launches


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


def phase_reference_train(**impls):
    """The reference phase's second half: one float32 train step (dropout
    0, depth 2 + 2, T=6) on the card and on the CPU (plain versions): loss
    within 1e-4, gradients within 1e-3 of each tensor's largest entry (key
    biases, whose gradient is zero but for rounding, within an absolute
    1e-6). ``impls`` overrides the config's ``*_impl`` keys."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_train_step)

    cfg = dict(flagship_config(), dtype="float32", vit_depth=2,
               num_decoder_layers=2, dropout=0.0, **impls)
    data = synthetic_batch_feed(1, 7, image_size=224, seed=3)
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(3))
        state = create_train_state(dict(model.named_parameters()),
                                   {"lr": 1e-5})
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        _, loss, _ = make_train_step(
            model, LossConfig(REFERENCE_CMD_WEIGHTS))(state, batch, 0)
        outs[device] = (loss.item(), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()})
    loss_err = abs(outs["cuda"][0] - outs["cpu"][0])
    worst, worst_name, noise = 0.0, "", 0.0
    for name, want in outs["cpu"][1].items():
        err = (outs["cuda"][1][name] - want).abs().max().item()
        if name.endswith(".key.bias"):
            # An attention key bias has a zero gradient in exact arithmetic
            # (a shift of a row's scores leaves its softmax unchanged):
            # both sides hold rounding noise, held to an absolute 1e-6.
            noise = max(noise, err)
            continue
        err /= max(want.abs().max().item(), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    print(f"reference: float32 train step (depth 2+2, T=6, dropout 0"
          f"{''.join(f', {k} {v}' for k, v in impls.items())}), card "
          f"vs CPU: loss {outs['cuda'][0]:.6f} vs {outs['cpu'][0]:.6f} (tol "
          f"1e-4); worst gradient error relative to its tensor's largest "
          f"entry {worst:.3g} at {worst_name} (tol 1e-3); key biases' noise "
          f"gradients differ by {noise:.3g} (tol 1e-6 absolute)", flush=True)
    check(noise <= 1e-6, f"a key bias gradient differs by {noise}")
    check(loss_err <= 1e-4, f"float32 train loss differs by {loss_err}")
    check(worst <= 1e-3, f"float32 gradient of {worst_name} differs by "
          f"{worst} of its largest entry")


# ---- The named configs beyond the flagship: GenCAD, multiview, ResNet,
# the decision transformer, and K1 at the GenCAD CAD encoder's T ----

WIDE_SEQ = 65      # the GenCAD CAD encoder: 8 x 8 patches of 256², and cls
NAMED = {   # phase -> (config file, name), each at its JSON's full width
    "G": ("transformer_experiments.json",
          "cad_past_10_actions_and_states_gencad"),        # :316
    "M": ("transformer_experiments.json",
          "cad_5_actions_and_states_and_multiview"),       # :335
    "R": ("autoregressive_transformer.json",
          "multiview_params_left_right_top"),              # :36
    "DT": ("vid_pretrained.json", "base_model"),           # :2
}
NAMED_TRAIN = {"G": (TRAIN_BATCH, TRAIN_SEQ), "M": (TRAIN_BATCH, TRAIN_SEQ),
               "R": (TRAIN_BATCH, 64), "DT": (TRAIN_BATCH, 64)}
SERVE_STEPS = 4    # steps of each of the 8 sessions of G's and M's serving


def named_config(phase):
    from videocad_tpu_torch.models.factory import load_named_config

    fname, name = NAMED[phase]
    return load_named_config(str(REPO / "model_configs" / fname), name)


def edge_images(n, seed):
    """uint8 (n, 256, 256, 3) stand-ins for GenCAD's Canny edge images,
    made without OpenCV: outlines of random rectangles, 255 on 0, the three
    channels equal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.zeros((n, 256, 256), np.uint8)
    for i in range(n):
        for _ in range(12):
            y, x = rng.integers(0, 196, 2)
            h, w = rng.integers(8, 60, 2)
            img[i, y, x:x + w + 1] = img[i, y + h, x:x + w + 1] = 255
            img[i, y:y + h + 1, x] = img[i, y:y + h + 1, x + w] = 255
    return np.repeat(img[..., None], 3, axis=-1)


def named_inputs(phase, batch, seed, channels=1):
    """What a batch of ``phase``'s config takes beyond frames, actions and
    a frame-sized CAD image: the edge images (G), or (B, V, 224, 224,
    ``channels``) uint8 multiview renders (M, R; a session request takes
    3 channels, as the JAX server does)."""
    import numpy as np

    cfg = named_config(phase)
    if cfg.get("use_pretrained_cad_model"):
        return {"cad_image": edge_images(batch, seed)}
    views = cfg.get("num_views", 0)
    if views:
        return {"multiview_images": np.random.default_rng(seed).integers(
            0, 256, (batch, views, 224, 224, channels), dtype=np.uint8)}
    return {}


def k1_counts(fa):
    """K1's launch counters: (forward, backward) launches, of the tc
    variant, of the wide instantiation."""
    return tuple(getattr(f, attr) for attr in ("launches", "tc_launches",
                                               "wide_launches")
                 for f in (fa.mhsa_short, fa.mhsa_short_backward))


def phase_named_train(phase, fa):
    """Train steps of a named config at its JSON's full width with seeded
    random weights: 1 warm-up and 3 timed steps at NAMED_TRAIN's B and T,
    224² uint8 frames; K1's launches a step (GenCAD: 6 + 6 of its wide
    instantiation, the CAD encoder, beside 6 + 6 of the state encoder's;
    its CAD encoder unchanged at learning rate 0). Returns the model."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state,
                                          make_train_step)

    cfg = named_config(phase)
    batch_size, seq = NAMED_TRAIN[phase]
    torch.cuda.reset_peak_memory_stats()
    start = time.monotonic()
    model = create_model(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    gencad = model.config.use_pretrained_cad_model
    state = create_train_state(dict(model.named_parameters()), {"lr": 1e-5},
                               freeze_cad=gencad)
    step_fn = make_train_step(model, LossConfig(REFERENCE_CMD_WEIGHTS))
    data = synthetic_batch_feed(batch_size, seq, image_size=224, seed=0)
    data.update(named_inputs(phase, batch_size, seed=1))
    batch = to_card(data)
    cad_before = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n.startswith("cad_encoder.")}
    losses, step_ms, per_step = [], [], []
    for _ in range(4):
        marks = k1_counts(fa)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, loss, _ = step_fn(state, batch, 0)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss.item())
        per_step.append(tuple(b - a for a, b in zip(marks, k1_counts(fa))))
    check(all(math.isfinite(x) for x in losses),
          f"{phase}: train losses {losses}")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    check(grads and all(bool(torch.isfinite(g).all()) for g in grads),
          f"{phase}: a gradient is not finite")
    if gencad:
        unchanged = all(torch.equal(p, cad_before[n])
                        for n, p in model.named_parameters()
                        if n.startswith("cad_encoder."))
        check(unchanged, "G: the CAD encoder moved at learning rate 0")
        # fwd, bwd launches; of them tc; of them the wide instantiation.
        want = (12, 12, 12, 12, 6, 6)
        check(all(c == want for c in per_step),
              f"G: K1 launches a step {per_step}, expected {want}")
    timed = step_ms[1:]
    ms = statistics.mean(timed)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{phase} train: {NAMED[phase][1]} ({cfg.get('dtype')}, "
          f"{model.config.encoder}, {n_params} parameters), B={batch_size} "
          f"T={seq}; losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(x, 2) for x in timed]} (mean {ms:.2f}, "
          f"{batch_size * (seq - 1) / ms * 1e3:.0f} frames/s); peak memory "
          f"{peak:.2f} GB; K1 launches a step (fwd, bwd, tc fwd, tc bwd, "
          f"wide fwd, wide bwd) {per_step[-1]}"
          + ("; CAD encoder unchanged" if gencad else "")
          + f"; {time.monotonic() - start:.1f} s", flush=True)
    return model


def phase_named_serve(phase, model, fa, np):
    """8 sessions on 8 lanes of the model's engine behind the HTTP server,
    opened with the config's session images (G: edge images; M: three
    views of 3 channels in the request), each stepped SERVE_STEPS frames
    from its own
    thread. GenCAD: each opened session launches the CAD encoder's wide
    K1 forward 6 times."""
    from videocad_tpu_torch.infer.server import (MuxEngine, ServingClient,
                                                 make_server)

    start = time.monotonic()
    engine = MuxEngine(model, lanes=LANES, seq_len=SEQ_LEN)
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(5)
    extra = named_inputs(phase, LANES, seed=6, channels=3)
    cads = extra.get("cad_image", rng.integers(
        0, 256, (LANES, 224, 224, 3), dtype=np.uint8))
    views = extra.get("multiview_images")
    frames = rng.integers(0, 256, (LANES, SERVE_STEPS, 224, 224, 3),
                          dtype=np.uint8)
    replies = [[None] * SERVE_STEPS for _ in range(LANES)]
    wide_before = fa.mhsa_short.wide_launches
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        sids = [client.open_session(cads[i], None if views is None
                                    else views[i]) for i in range(LANES)]
        wide = fa.mhsa_short.wide_launches - wide_before

        def run(i):
            for s in range(SERVE_STEPS):
                replies[i][s] = client.step(sids[i], frames[i][s])

        workers = [threading.Thread(target=run, args=(i,))
                   for i in range(LANES)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
            check(not w.is_alive(), f"{phase} serve: a client thread hung")
        stats = client.stats()
        for sid in sids:
            client.close_session(sid)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    for i in range(LANES):
        for s in range(SERVE_STEPS):
            check(replies[i][s] is not None and valid_reply(replies[i][s], s),
                  f"{phase} serve: session {i} step {s}: {replies[i][s]}")
    check(stats["steps"] == LANES * SERVE_STEPS, f"{phase} serve {stats}")
    if model.config.use_pretrained_cad_model:
        check(wide >= 6 * LANES, f"G serve: {wide} wide K1 launches for "
              f"{LANES} sessions, expected 6 a session")
    print(f"{phase} serve: {LANES} sessions x {SERVE_STEPS} steps"
          f"{' with 3 views a session' if views is not None else ''}; "
          f"ticks {stats['ticks']}, coalescing {stats['coalescing_factor']}, "
          f"tick ms p50 {stats['p50_tick_ms']} p95 {stats['p95_tick_ms']}; "
          f"wide K1 launches while opening {wide}; "
          f"{time.monotonic() - start:.1f} s", flush=True)


def phase_named_rollout(phase, model, fa, batch=2, seq=SEQ_LEN):
    """sequential_inference at B=2, T=187 with the config's inputs: the
    KV-cached decode loop (G, M), or the one pass of a config without
    action feedback (R)."""
    import torch

    from videocad_tpu_torch.infer.rollout import sequential_inference

    gen = torch.Generator(device="cuda").manual_seed(7)
    frames = torch.randint(0, 256, (batch, seq, 224, 224, 3), generator=gen,
                           dtype=torch.uint8, device="cuda")
    extra = {k: torch.from_numpy(v).cuda()
             for k, v in named_inputs(phase, batch, seed=8).items()}
    cad = extra.get("cad_image", torch.randint(
        0, 256, (batch, 224, 224, 3), generator=gen, dtype=torch.uint8,
        device="cuda"))
    torch.cuda.synchronize()
    start = time.monotonic()
    cmd, par = sequential_inference(
        model, frames, cad, multiview_images=extra.get("multiview_images"))
    torch.cuda.synchronize()
    seconds = time.monotonic() - start
    check(tuple(cmd.shape) == (batch, seq, 5)
          and tuple(par.shape) == (batch, seq, 6, 1000)
          and bool(torch.isfinite(cmd).all())
          and bool(torch.isfinite(par).all()),
          f"{phase} rollout: shapes {tuple(cmd.shape)} {tuple(par.shape)} "
          "or logits not finite")
    loop = "decode loop" if model.config.enable_past_actions else "one pass"
    print(f"{phase} rollout: B={batch} T={seq} in {seconds:.2f} s "
          f"({batch * seq / seconds:.1f} actions/s; {loop})", flush=True)


def phase_reference_named(phase):
    """A named config in float32 at a small depth (ViT 2 blocks, decoder
    and GPT-2 blocks 2 layers; widths as the JSON has them), on the card
    and on the CPU (plain versions; the GenCAD CAD encoder through K1's
    wide scalar kernel on the card): logits within 1e-3, the reference
    phase's tolerance."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model

    cfg = dict(named_config(phase), dtype="float32", vit_depth=2,
               num_decoder_layers=2, n_layer=2, dropout=0.0)
    data = synthetic_batch_feed(1, 6, image_size=224, seed=9)
    data.update(named_inputs(phase, 1, seed=10))
    data.pop("timesteps")
    outs = {}
    for device in ("cuda", "cpu"):
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs[device] = [x.cpu() for x in model(
                {k: torch.from_numpy(v).to(device) for k, v in data.items()})]
    errs = [(g - w).abs().max().item()
            for g, w in zip(outs["cuda"], outs["cpu"])]
    print(f"reference {phase}: {NAMED[phase][1]} float32 (depth 2), card vs "
          f"CPU max abs err cmd {errs[0]:.3g} params {errs[1]:.3g} "
          "(tol 1e-3)", flush=True)
    check(all(math.isfinite(e) and e <= 1e-3 for e in errs),
          f"reference {phase}: the card's logits differ from the CPU's: "
          f"{errs}")


def shifted_identity(batch, t, offset, dtype):
    """(B, T, H*D) whose head slice holds 1 at (offset + c, c): as V the
    output's column c is the dropped weight of key offset + c."""
    import torch

    d = WIDTH // HEADS
    eye = torch.zeros(t, d, device="cuda", dtype=dtype)
    rows = torch.arange(offset, min(offset + d, t), device="cuda")
    eye[rows, rows - offset] = 1
    return eye.repeat(1, HEADS).expand(batch, t, WIDTH).contiguous()


def kept_set_wide(run, batch, t, dtype):
    """The kept set (B, H, T, T) read off ``run(values)``'s output under
    shifted identities, keys 0..63 and T-64..T-1 (T <= 128)."""
    import torch

    d = WIDTH // HEADS
    kept = torch.zeros(batch, HEADS, t, t, dtype=torch.bool, device="cuda")
    for offset in (0, max(t - d, 0)):
        span = min(d, t - offset)
        out = run(shifted_identity(batch, t, offset, dtype))
        kept[..., offset:offset + span] = out.reshape(
            batch, t, HEADS, d)[..., :span].permute(0, 2, 1, 3) > 0
    return kept


def phase_k1_wide(fa, prng):
    """K1 at T = 65, its wide instantiation (GenCAD's CAD encoder): forward
    and backward against the plain versions at B = 8 and 1 (the path's) and
    1,528 (where the host does not bound a call), bf16 (tc) and float32
    (scalar), dropout 0 and 0.1: values (K1's tolerances at T = 50), the
    kept set (identical to the plain version's and the bit function's),
    gradients bit-equal over two launches, float32 against autograd
    through the plain forward; the kernels and the plain versions timed in
    turns, F.scaled_dot_product_attention (and its autograd backward)
    beside them; the bound."""
    import torch
    import torch.nn.functional as F

    t = WIDE_SEQ
    gen = torch.Generator(device="cuda").manual_seed(11)
    heads = lambda x: x.view(x.shape[0], t, HEADS, -1).transpose(1, 2)  # noqa: E731
    rows = []
    cases = [(b, torch.bfloat16, rate) for b in (8, 1, TRAIN_FRAMES)
             for rate in (0.0, RATE)]
    cases += [(8, torch.float32, rate) for rate in (0.0, RATE)]
    for b, dtype, rate in cases:
        bf16 = dtype == torch.bfloat16
        max_tol, mean_tol = (2e-2, 1e-3) if bf16 else (1e-5, 1e-5)
        q, k, v, g = (randn((b, t, WIDTH), gen, dtype) for _ in range(4))
        seed = 3000 + b if rate else None
        reps = dict(reps=3, groups=3, warmup=1) if b > 8 else {}
        base = {"batch": b, "rate": rate, "dtype": dtype_name(dtype),
                "seq": t, "variant": fa._kernel_variant(dtype, t, 64)}
        itemsize = 2 if bf16 else 4
        cells = b * HEADS * t * t * (WIDTH // HEADS)
        # forward
        with torch.no_grad():
            marks = k1_counts(fa)
            got = fa.mhsa_short(q, k, v, seed, HEADS, rate)
            torch.cuda.synchronize()
            moved = tuple(y - x for x, y in zip(marks, k1_counts(fa)))
            want = fa.mhsa_short_reference(q, k, v, seed, HEADS, rate)
            err = (got.float() - want.float()).abs()
            row = dict(base, kernel="mhsa_short_wide",
                       max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item())
            if rate:
                keep = prng.keep_mask(prng.dropout_bits(
                    seed, b, HEADS, t, t, device="cuda"), rate)
                kept = kept_set_wide(lambda eye: fa.mhsa_short(
                    q, k, eye, seed, HEADS, rate), b, t, dtype)
                kept_plain = kept_set_wide(lambda eye: fa.mhsa_short_reference(
                    q, k, eye, seed, HEADS, rate), b, t, dtype)
                positive = kept_set_wide(lambda eye: fa.mhsa_short(
                    q, k, eye, None, HEADS), b, t, dtype)
                row["kept_set_identical"] = (
                    torch.equal(kept, kept_plain)
                    and torch.equal(kept, keep & positive))
                del keep, kept, kept_plain, positive
            row["ms"], row["plain_ms"] = in_turns(
                lambda: fa.mhsa_short(q, k, v, seed, HEADS, rate),
                lambda: fa.mhsa_short_reference(q, k, v, seed, HEADS, rate),
                **reps)
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), dropout_p=rate))
        row.update(bound(4 * b * t * WIDTH * itemsize, 4 * cells,
                         row["dtype"]))
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        print(f"mhsa_short_wide {row}", flush=True)
        check(moved == (1, 0, int(bf16), 0, 1, 0),
              f"mhsa_short T={t} B={b} {dtype}: launches moved {moved}, "
              "expected one of the wide instantiation")
        check(math.isfinite(row["max_abs_err"])
              and row["max_abs_err"] <= max_tol
              and row["mean_abs_err"] <= mean_tol,
              f"mhsa_short T={t} B={b} {dtype} rate {rate}: {row}")
        check(row.get("kept_set_identical", True),
              f"mhsa_short T={t} B={b} {dtype} rate {rate}: the kept set is "
              "not the plain version's")
        rows.append(row)
        # backward
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        marks = k1_counts(fa)
        fa.mhsa_short(*leaves, seed, HEADS, rate).backward(g)
        torch.cuda.synchronize()
        moved = tuple(y - x for x, y in zip(marks, k1_counts(fa)))
        grads = [x.grad for x in leaves]
        with torch.no_grad():
            again = fa.mhsa_short_backward(q, k, v, g, seed, HEADS, rate)
            want = fa.mhsa_short_backward_reference(q, k, v, g, seed, HEADS,
                                                    rate)
        repeats = all(torch.equal(a, x) for a, x in zip(grads, again))
        errs = [(a.float() - w.float()).abs() for a, w in zip(grads, want)]
        row = dict(base, kernel="mhsa_short_bwd_wide",
                   max_abs_err=max(e.max().item() for e in errs),
                   mean_abs_err=max(e.mean().item() for e in errs),
                   bit_equal_repeat=repeats)
        del again, want, errs
        if not bf16:
            ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(fa.mhsa_short_reference(
                *ref_leaves, seed, HEADS, rate), ref_leaves, g)
            row["max_abs_err_vs_autograd"] = max(
                (a - w).abs().max().item() for a, w in zip(grads, auto))
        with torch.no_grad():
            row["ms"], row["plain_ms"] = in_turns(
                lambda: fa.mhsa_short_backward(q, k, v, g, seed, HEADS, rate),
                lambda: fa.mhsa_short_backward_reference(q, k, v, g, seed,
                                                         HEADS, rate),
                **reps)
        lib = [heads(x).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*lib, dropout_p=rate)
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, lib, heads(g), retain_graph=True))
        del lib, out
        row.update(bound(7 * b * t * WIDTH * itemsize, 10 * cells,
                         row["dtype"]))
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        print(f"mhsa_short_bwd_wide {row}", flush=True)
        check(moved == (1, 1, int(bf16), int(bf16), 1, 1),
              f"mhsa_short backward T={t} B={b} {dtype}: launches moved "
              f"{moved}, expected a forward and a backward of the wide "
              "instantiation")
        check(repeats, f"mhsa_short backward T={t} B={b} {dtype} rate {rate}:"
              " two launches gave different gradients")
        check(math.isfinite(row["max_abs_err"])
              and row["max_abs_err"] <= max_tol
              and row["mean_abs_err"] <= mean_tol
              and row.get("max_abs_err_vs_autograd", 0.0) <= 1e-5,
              f"mhsa_short backward T={t} B={b} {dtype} rate {rate}: {row}")
        rows.append(row)
        del q, k, v, g, leaves, grads
    return rows


def phase_named(counters, fa, np):
    """The G, M, R and DT phases, each driven with the launch counters at
    0 and read just after; returns {phase: launches}."""
    import torch

    launches = {}
    for phase in NAMED:
        start = time.monotonic()
        for reset in counters.values():
            reset(0)
        model = phase_named_train(phase, fa)
        if phase in ("G", "M"):
            phase_named_serve(phase, model, fa, np)
        if phase != "DT":
            phase_named_rollout(phase, model, fa)
        if phase == "G":
            # cad_saliency through the GenCAD CAD encoder: K1's wide
            # backward.
            _, _, wide = run_saliency(model, saliency_batch(
                SALIENCY_BATCH, seed=27,
                cad=edge_images(SALIENCY_BATCH, 28)), fa, "G")
            check(wide > 0, "G saliency launched no wide K1 backward")
        launches[phase] = {name: read() for name, read in counters.items()}
        del model
        torch.cuda.empty_cache()
        print(f"{phase} phase: {time.monotonic() - start:.1f} s; launches "
              f"{ {k: v for k, v in launches[phase].items() if v} }",
              flush=True)
    return launches


# ---- S: the serving and inference layer: the quantized decode, the
# incremental step, saliency and attention rollout, the port's artifacts ----

QUANT_MODES = ("none", "int8", "int4")
S_BATCH = 2        # the quantized rollout's and the incremental decode's B
SALIENCY_BATCH = 8
ARTIFACT_SESSIONS = 3


def flagship(device, dtype=None, depth=None, seed=0):
    """The flagship config's model on ``device`` with random weights from
    ``seed``: as its JSON has it, or at ``dtype`` with the ViT and the
    decoder cut to ``depth``."""
    import torch

    from videocad_tpu_torch.models.factory import create_model, flagship_config

    cfg = flagship_config()
    if dtype is not None:
        cfg = dict(cfg, dtype=dtype, vit_depth=depth,
                   num_decoder_layers=depth)
    return create_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(seed))


def s_frames(batch, seq, seed, device="cuda"):
    """Seeded uint8 (batch, seq, 224, 224, 3) frames and (batch, 224, 224,
    3) CAD images."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (batch, seq, 224, 224, 3), generator=gen,
                           dtype=torch.uint8)
    cad = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen,
                        dtype=torch.uint8)
    return frames.to(device), cad.to(device)


def timed(fn, n=3):
    """(the last result, the median ms over ``n`` calls), host clock around
    a synchronised call."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return out, statistics.median(times)


def agreement(cmd, want):
    """The share of steps whose argmax command equals ``want``'s."""
    return (cmd.argmax(-1) == want.argmax(-1)).float().mean().item()


def quant_dense_pairs(model, bits, dtype):
    """(path, quantized dense, float32 weight (out, in)) of each dense of
    quantize_for_decode's decoder (q/k/v fused), beside the model's own
    weights fused the same way."""
    from videocad_tpu_torch.infer.rollout import (fuse_self_qkv, param_tree,
                                                  quantize_for_decode)

    quant = quantize_for_decode(model, dtype, bits)["decoder"]
    plain = fuse_self_qkv(param_tree(model)["decoder"])

    def walk(q, p, path):
        if "scale" in q:
            yield path, q, p["weight"].float()
        else:
            for key in q:
                if isinstance(q[key], dict):
                    yield from walk(q[key], p[key], path + "/" + key)
    return list(walk(quant, plain, "decoder"))


def phase_s_quant(model, np):
    """S1: sequential_inference at B=2, T=187 under none / int8 / int4, each
    timed (median of 3); the integers against the float32 weights; the
    quantized rollout at float32, depth 2, on the card against the CPU."""
    import torch

    from videocad_tpu_torch.infer.rollout import (dequantized_weight,
                                                  sequential_inference)

    frames, cad = s_frames(S_BATCH, SEQ_LEN, seed=21)
    results = {}
    for mode in QUANT_MODES:
        (cmd, par), ms = timed(lambda: sequential_inference(
            model, frames, cad, weight_quant=mode))
        check(bool(torch.isfinite(cmd).all()) and bool(
            torch.isfinite(par).all()), f"S rollout {mode}: not finite")
        results[mode] = {"ms": ms, "actions_per_s": S_BATCH * SEQ_LEN / ms
                         * 1e3, "cmd": cmd}
    none_cmd = results["none"]["cmd"]
    for mode in QUANT_MODES:
        results[mode]["cmd_agreement"] = agreement(results[mode].pop("cmd"),
                                                   none_cmd)
    # The integers: the path's (scale in bf16) equal those of a float32
    # scale, and those dequantized lie within scale / 2 of the weights (in
    # float64; w / scale is rounded to float32 before it is rounded to an
    # integer, which may add qmax * 2^-24 scale to the half).
    for mode, bits in (("int8", 8), ("int4", 4)):
        qmax = {8: 127, 4: 7}[bits]
        path_q = quant_dense_pairs(model, bits, None)
        f32_q = quant_dense_pairs(model, bits, torch.float32)
        worst = 0.0
        for (path, q, w), (_, q32, _) in zip(path_q, f32_q):
            ints = dequantized_weight(q)
            check(torch.equal(ints, dequantized_weight(q32)),
                  f"S {mode}: {path}: integers depend on the scale's dtype")
            check(int(ints.abs().max()) <= qmax,
                  f"S {mode}: {path}: integers out of range")
            scale = q32["scale"].double()[:, None]
            err = ((ints.double() * scale - w.double()).abs()
                   / scale).max().item()
            worst = max(worst, err)
        limit = 0.5 + qmax * 2.0 ** -24
        check(worst <= limit, f"S {mode}: dequantized weights off by "
              f"{worst} scale (limit {limit})")
        results[mode]["dequant_err_in_scales"] = worst
    # float32, depth 2: card against CPU.
    frames_s, cad_s = s_frames(1, 6, seed=22, device="cpu")
    for mode in ("int8", "int4"):
        outs = {}
        for device in ("cuda", "cpu"):
            small = flagship(device, "float32", 2, seed=3)
            outs[device] = [x.cpu() for x in sequential_inference(
                small, frames_s.to(device), cad_s.to(device),
                weight_quant=mode)]
        errs = [(g - w).abs().max().item()
                for g, w in zip(outs["cuda"], outs["cpu"])]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(outs["cuda"], outs["cpu"]))
        check(all(e <= 1e-5 for e in errs) and same,
              f"S {mode}: float32 rollout card vs CPU {errs}, actions "
              f"equal {same}")
        results[mode]["f32_card_vs_cpu"] = errs
    for mode in QUANT_MODES:
        print(f"S rollout {mode}: B={S_BATCH} T={SEQ_LEN} "
              f"{results[mode]['ms']:.1f} ms (median of 3), "
              f"{results[mode]['actions_per_s']:.1f} actions/s; commands "
              f"agreeing with none {results[mode]['cmd_agreement']:.4f}"
              + (f"; dequantized within "
                 f"{results[mode]['dequant_err_in_scales']:.4f} scale; f32 "
                 f"depth 2 card vs CPU {results[mode]['f32_card_vs_cpu']}"
                 if mode != "none" else ""), flush=True)
    return results


def drive_incremental(model, params, frames, cad):
    """incremental_decode_step over every frame -> (cmd, par) stacked, and
    the ms of the whole loop (host clock, synchronised at both ends)."""
    import torch

    from videocad_tpu_torch.infer.incremental import (incremental_decode_step,
                                                      init_decode_carry)

    torch.cuda.synchronize()
    t0 = time.monotonic()
    carry = init_decode_carry(model, cad, frames.shape[1])
    cmds, pars = [], []
    for i in range(frames.shape[1]):
        carry, cmd, par = incremental_decode_step(model, params,
                                                  frames[:, i], carry)
        cmds.append(cmd)
        pars.append(par)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    check(int(carry["t"]) == frames.shape[1], "incremental: wrong step count")
    return torch.stack(cmds, 1), torch.stack(pars, 1), ms


def phase_s_incremental(model, fa):
    """S2: incremental_decode_step 187 times at B=2 under none and int8 on
    the bf16 flagship (agreement with the batch rollout printed), K1's
    forward counted (tc variant); at float32, depth 2, the step's logits
    against sequential_inference within 1e-5 and its actions equal."""
    import torch

    from videocad_tpu_torch.infer.rollout import (decode_params,
                                                  sequential_inference)

    frames, cad = s_frames(S_BATCH, SEQ_LEN, seed=23)
    results = {}
    for mode in ("none", "int8"):
        before = (fa.mhsa_short.launches, fa.mhsa_short.tc_launches)
        cmd, par, ms = drive_incremental(model, decode_params(model, mode),
                                         frames, cad)
        k1, k1_tc = (fa.mhsa_short.launches - before[0],
                     fa.mhsa_short.tc_launches - before[1])
        # One frame encode a step and one CAD encode: 6 blocks each.
        check(k1_tc == k1 == 6 * (SEQ_LEN + 1),
              f"S incremental {mode}: K1 launches {k1} (tc {k1_tc}), "
              f"expected {6 * (SEQ_LEN + 1)} of the tc variant")
        want = sequential_inference(model, frames, cad, weight_quant=mode)
        results[mode] = {"ms_per_step": ms / SEQ_LEN, "k1_launches": k1,
                         "cmd_agreement": agreement(cmd, want[0]),
                         "param_agreement": agreement(par, want[1])}
    frames32, cad32 = s_frames(S_BATCH, SEQ_LEN, seed=24)
    small = flagship("cuda", "float32", 2, seed=4)
    for mode in ("none", "int8"):
        cmd, par, _ = drive_incremental(small, decode_params(small, mode),
                                        frames32, cad32)
        want = sequential_inference(small, frames32, cad32,
                                    weight_quant=mode)
        errs = [(g - w).abs().max().item()
                for g, w in zip((cmd, par), want)]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip((cmd, par), want))
        check(all(e <= 1e-5 for e in errs) and same,
              f"S incremental {mode}: float32 depth 2 against the rollout "
              f"{errs}, actions equal {same}")
        results[mode]["f32_vs_rollout"] = errs
    for mode, r in results.items():
        print(f"S incremental {mode}: B={S_BATCH}, {SEQ_LEN} steps, "
              f"{r['ms_per_step']:.2f} ms a step; K1 forward launches "
              f"{r['k1_launches']} (tc); bf16 agreement with the rollout: "
              f"commands {r['cmd_agreement']:.4f}, parameters "
              f"{r['param_agreement']:.4f}; float32 depth 2 against the "
              f"rollout {r['f32_vs_rollout']} (tol 1e-5, actions equal)",
              flush=True)
    return results


def saliency_batch(batch, seed, cad=None):
    """A saliency batch: 2 frames and integer actions a row, and a CAD
    image (frame-sized, or ``cad``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    actions = np.concatenate([rng.integers(0, 5, (batch, 2, 1)),
                              rng.integers(-1, 1000, (batch, 2, 6))], -1)
    return to_card({
        "frames": rng.integers(0, 256, (batch, 2, 224, 224, 3),
                               dtype=np.uint8),
        "actions": actions.astype(np.float32),
        "cad_image": (cad if cad is not None else rng.integers(
            0, 256, (batch, 224, 224, 3), dtype=np.uint8))})


def run_saliency(model, batch, fa, label):
    """cad_saliency under torch.no_grad(), timed (median of 3): K1's
    backward launches counted, the heatmaps finite and nonzero. Returns
    (ms, K1 backward launches a call, of them wide)."""
    import torch

    from videocad_tpu_torch.infer.interpret import cad_saliency

    before = (fa.mhsa_short_backward.launches,
              fa.mhsa_short_backward.wide_launches)
    with torch.no_grad():
        (_, sal), ms = timed(lambda: cad_saliency(model, batch))
    bwd, wide = (fa.mhsa_short_backward.launches - before[0],
                 fa.mhsa_short_backward.wide_launches - before[1])
    b, h, w = batch["cad_image"].shape[:3]
    check(tuple(sal.shape) == (b, h, w) and bool(torch.isfinite(sal).all())
          and sal.abs().sum().item() > 0,
          f"{label} saliency: shape {tuple(sal.shape)}, or not finite, or "
          "all zero")
    check(bwd > 0 and bwd % 3 == 0,
          f"{label} saliency: {bwd} K1 backward launches in 3 calls")
    print(f"{label} saliency: B={b} {ms:.1f} ms (median of 3); K1 backward "
          f"launches a call {bwd // 3} (wide {wide // 3})", flush=True)
    return ms, bwd // 3, wide // 3


def phase_s_interpret(model, fa):
    """S3: cad_saliency at B=8 (K1's backward under "fused"), and
    attention_rollout at B=8, (8, 224, 224); the rollout at float32, depth
    2, on the card against the CPU within 1e-5."""
    import torch

    from videocad_tpu_torch.infer.interpret import attention_rollout

    batch = saliency_batch(SALIENCY_BATCH, seed=25)
    sal_ms, bwd, _ = run_saliency(model, batch, fa, "S")
    heat, roll_ms = timed(lambda: attention_rollout(model,
                                                    batch["cad_image"]))
    check(tuple(heat.shape) == (SALIENCY_BATCH, 224, 224)
          and bool(torch.isfinite(heat).all()),
          f"S attention rollout: shape {tuple(heat.shape)} or not finite")
    outs = {}
    for device in ("cuda", "cpu"):
        small = flagship(device, "float32", 2, seed=5)
        outs[device] = attention_rollout(
            small, batch["cad_image"].to(device), discard_ratio=0.5).cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    check(err <= 1e-5, f"S attention rollout: float32 depth 2 card vs CPU "
          f"{err}")
    print(f"S attention rollout: B={SALIENCY_BATCH} {roll_ms:.1f} ms (median "
          f"of 3), heatmaps {tuple(heat.shape)}; float32 depth 2 card vs "
          f"CPU {err:.3g} (tol 1e-5)", flush=True)
    return {"saliency_ms": sal_ms, "saliency_k1_bwd": bwd,
            "attention_rollout_ms": roll_ms, "rollout_f32_err": err}


def phase_s_artifact(model, np, root):
    """S4: cli.export_model.main writes the flagship (seed 0) with 8 lanes
    and int8; cli.serve --artifact serves it over HTTP (3 sessions x 10
    steps, some concurrent) through ArtifactMuxEngine; the actions equal a
    live MuxEngine(weight_quant="int8")'s on the same frames."""
    from videocad_tpu_torch.cli import export_model as export_cli
    from videocad_tpu_torch.cli.serve import build_engine, parse_args
    from videocad_tpu_torch.infer.server import (ArtifactMuxEngine,
                                                 MuxEngine, ServingClient,
                                                 make_server)
    from videocad_tpu_torch.models.factory import FLAGSHIP_NAME

    path = os.path.join(root, "flagship.vcdx")
    start = time.monotonic()
    meta = export_cli.main([
        "--device", "cuda", "--model_config",
        str(REPO / "model_configs" / "transformer_experiments.json"),
        "--model_name", FLAGSHIP_NAME, "--batch", "1", "--bucket",
        str(SEQ_LEN), "--lanes", str(LANES), "--weight_quant", "int8",
        "--out", path])
    export_s = time.monotonic() - start
    size_mb = os.path.getsize(path) / 1e6
    start = time.monotonic()
    engine = build_engine(parse_args(["--device", "cuda", "--artifact",
                                      path]))
    load_s = time.monotonic() - start
    check(isinstance(engine, ArtifactMuxEngine)
          and engine.meta()["weight_quant"] == "int8",
          f"S artifact: engine {engine.meta()}")
    rng = np.random.default_rng(26)
    cads = rng.integers(0, 256, (ARTIFACT_SESSIONS, 224, 224, 3),
                        dtype=np.uint8)
    frames = rng.integers(0, 256, (ARTIFACT_SESSIONS, STEPS, 224, 224, 3),
                          dtype=np.uint8)
    replies = [[None] * STEPS for _ in range(ARTIFACT_SESSIONS)]
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        sids = [client.open_session(c) for c in cads]

        def run(i):
            for s in range(STEPS):
                replies[i][s] = client.step(sids[i], frames[i][s])

        workers = [threading.Thread(target=run, args=(i,))
                   for i in range(ARTIFACT_SESSIONS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
            check(not w.is_alive(), "S artifact: a client thread hung")
        stats = client.stats()
        for sid in sids:
            client.close_session(sid)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    del engine
    live = MuxEngine(model, lanes=LANES, seq_len=SEQ_LEN,
                     weight_quant="int8")
    try:
        live_sids = [live.open_session(c)[0] for c in cads]
        for i in range(ARTIFACT_SESSIONS):
            for s in range(STEPS):
                want = live.step(live_sids[i], frames[i][s])
                got = replies[i][s]
                check(got is not None and valid_reply(got, s)
                      and (got["cmd"], got["params"]) == (want["cmd"],
                                                          want["params"]),
                      f"S artifact: session {i} step {s}: {got} against "
                      f"the live engine's {want}")
    finally:
        live.stop()
    check(stats["steps"] == ARTIFACT_SESSIONS * STEPS, f"S artifact {stats}")
    print(f"S artifact: {size_mb:.0f} MB written in {export_s:.1f} s, loaded "
          f"in {load_s:.1f} s (meta {json.dumps(meta)}); "
          f"{ARTIFACT_SESSIONS} sessions x {STEPS} steps over HTTP equal "
          f"the live int8 engine's; ticks {stats['ticks']}, coalescing "
          f"{stats['coalescing_factor']}, tick ms p50 {stats['p50_tick_ms']} "
          f"p95 {stats['p95_tick_ms']} mean {stats['mean_tick_ms']}",
          flush=True)
    return {"tick_p50_ms": stats["p50_tick_ms"],
            "tick_p95_ms": stats["p95_tick_ms"], "export_s": export_s,
            "load_s": load_s}


def phase_s(counters, fa, np):
    """Phase S, driven with the launch counters at 0 and read just after:
    the flagship (bf16, seed 0) through the serving and inference layer.
    Returns (launches, the phase's numbers)."""
    import torch

    start = time.monotonic()
    for reset in counters.values():
        reset(0)
    model = flagship("cuda")
    root = tempfile.mkdtemp(prefix="videocad_smoke_s_")
    try:
        numbers = {"rollout": phase_s_quant(model, np),
                   "incremental": phase_s_incremental(model, fa),
                   "interpret": phase_s_interpret(model, fa),
                   "artifact": phase_s_artifact(model, np, root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: read() for name, read in counters.items()}
    del model
    torch.cuda.empty_cache()
    for name in ("mhsa_short", "mhsa_short_bwd"):
        check(launches[name] > 0, f"phase S launched no {name} kernel")
    print(f"S phase: {time.monotonic() - start:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(json.dumps({"phase_s": numbers}), flush=True)
    return launches


# ---- The training entry point's last single-card options: the C++ .vcb
# loader (N), int8 dense layers (Q), remat_encoder and frame_chunk (RM), the
# warm start from a reference torch checkpoint (W) ----

def native_snapshot():
    """(name -> (mtime_ns, bytes)) of every file under the repository's
    native/, which the port must never write."""
    root = REPO / "native"
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes())
            for p in sorted(root.iterdir())}


def train_once(model, batch, steps, seed=0, marks=None):
    """``steps`` train steps of ``model`` on ``batch`` (Adam at 1e-5):
    (losses, host ms of each step around a device sync, the final
    state); ``marks`` () -> a tuple of counts read before and after each
    step, whose differences are returned too."""
    import torch

    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state, make_train_step)

    state = create_train_state(dict(model.named_parameters()), {"lr": 1e-5})
    train_step = make_train_step(model, LossConfig(REFERENCE_CMD_WEIGHTS))
    losses, step_ms, counted = [], [], []
    for _ in range(steps):
        before = marks() if marks else ()
        torch.cuda.synchronize()
        start = time.monotonic()
        state, loss, _ = train_step(state, batch, seed)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - start) * 1e3)
        losses.append(loss.item())
        if marks:
            counted.append(tuple(b - a for a, b in zip(before, marks())))
    return losses, step_ms, state, counted


def phase_n(counters, card, root, dataset_argv):
    """Phase N: train C's store converted to .vcb shards, the C++ loader's
    epoch against the thread pipeline's byte for byte and both timed, then
    cli.train.main --native_loader --quant int8 (ln_impl and dropout_impl
    "pallas"), one epoch of 2 steps at B=8 with validation and a
    checkpoint, no host sync in the epoch loop. Returns (launches of the
    CLI run, the phase's numbers)."""
    import torch

    from videocad_tpu_torch.cli import train as cli_train
    from videocad_tpu_torch.data import native
    from videocad_tpu_torch.data.dataset import VideoCADDataset, load_split_ids
    from videocad_tpu_torch.data.pipeline import DataPipeline
    from videocad_tpu_torch.models.factory import (FLAGSHIP_NAME,
                                                   flagship_config)
    from videocad_tpu_torch.ops import quant
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    from videocad_tpu_torch.train.trainer import Trainer

    before = native_snapshot()
    data_dir, split_path = dataset_argv[1], dataset_argv[3]
    splits = load_split_ids(split_path)
    start = time.monotonic()
    library = native.build_library()
    build_s = time.monotonic() - start
    check(Path(library).parent == REPO / "build" / "native",
          f"the native loader was built at {library}")
    vcb_dir = os.path.join(root, "vcb")
    start = time.monotonic()
    converted = {split: native.convert_store_to_vcb(
        data_dir, os.path.join(vcb_dir, split), ids=splits[split])
        for split in ("train", "val", "test")}
    convert_s = time.monotonic() - start
    paths = native.scan_vcb(os.path.join(vcb_dir, "train"))
    store_mb = sum(os.path.getsize(p) for split in converted
                   for p in native.scan_vcb(os.path.join(vcb_dir, split))
                   ) / 1e6
    shape, views, cad_shape = cli_train._probe_shape(paths[0])
    check(shape == cad_shape == (224, 224, 3) and views == 0,
          f"converted shards of {shape}, {views} views, CAD {cad_shape}")

    def epochs(pipe, n=3):
        """The first epoch's batches, and the ms between batches (from
        the epoch's start for the first) over ``n`` epochs."""
        kept, gaps = None, []
        for epoch in range(n):
            batches, mark = [], time.monotonic()
            for batch in pipe.epoch(epoch):
                now = time.monotonic()
                gaps.append((now - mark) * 1e3)
                mark = now
                batches.append(batch)
            kept = kept or batches
        return kept, gaps

    ours, native_gaps = epochs(native.NativePipeline(
        paths, batch_size=TRAIN_BATCH, bucket_len=TRAIN_SEQ,
        image_shape=shape, shuffle=False))
    theirs, thread_gaps = epochs(DataPipeline(
        VideoCADDataset(data_dir, ids=splits["train"]),
        batch_size=TRAIN_BATCH, buckets=(TRAIN_SEQ,), shuffle=False))
    check(len(ours) == len(theirs) == 2,
          f"{len(ours)} native and {len(theirs)} thread batches an epoch")
    for got, want in zip(ours, theirs):
        check(got["ids"] == want["ids"],
              f"ids {got['ids']} against {want['ids']}")
        for key in ("frames", "actions", "cad_image", "timesteps"):
            check(got[key].dtype == want[key].dtype
                  and got[key].shape == want[key].shape
                  and got[key].tobytes() == want[key].tobytes(),
                  f"the native loader's {key} differs from DataPipeline's")
    del ours, theirs

    name = FLAGSHIP_NAME + "_native_int8"
    params = dict(flagship_config(), ln_impl="pallas", dropout_impl="pallas")
    params["train_config"] = {"experiment_name": "phase_n",
                              "save_frequency": 1, "val_frequency": 1,
                              "log_frequency": 2}
    config_path = os.path.join(root, "model_config_n.json")
    with open(config_path, "w") as f:
        json.dump({name: params}, f)
    argv = dataset_argv + [
        "--model_config", config_path, "--model_name", name,
        "--device", "cuda", "--batch_size", str(TRAIN_BATCH), "--lr", "1e-5",
        "--no_enable_random", "--epochs", "1",
        "--checkpoint_dir", os.path.join(root, "checkpoints_n"),
        "--log_dir", os.path.join(root, "logs_n"),
        "--class_weights", os.path.join(root, "no_class_weights"),
        "--native_loader", "--vcb_dir", vcb_dir, "--quant", "int8"]
    for reset in counters.values():
        reset(0)                      # phase N's path starts here
    q8_mark = quant._q8_dot.launches
    start = time.monotonic()
    with EpochWatch(Trainer, CheckpointHandler, counters) as watch:
        results = cli_train.main(argv)
    run_s = time.monotonic() - start
    launches = {k: read() for k, read in counters.items()}  # and ends here
    q8 = quant._q8_dot.launches - q8_mark
    check(not watch.syncs, "phase N's epoch loop synchronised the host "
          "outside its logging fetch:\n" + "\n".join(watch.syncs[:10]))
    check(len(watch.epochs) == 1 and watch.epochs[0]["steps"] == 2,
          f"phase N ran {watch.epochs}")
    check(results["total_predictions"] > 0
          and math.isfinite(results["overall_accuracy"]),
          f"phase N's test results {results}")
    with open(os.path.join(root, "logs_n", "phase_n", "params.json")) as f:
        check(json.load(f)["quant"] == "int8", "params.json lacks quant")
    check(CheckpointHandler("phase_n", os.path.join(root, "checkpoints_n")
                            ).latest_epoch() == "epoch_1",
          "phase N saved no checkpoint")
    per_step = {k: v / 2 for k, v in watch.epochs[0]["launches"].items()}
    for kernel in ("layer_norm_fwd", "layer_norm_bwd", "hw_dropout",
                   "mhsa_short", "mhsa_short_bwd"):
        check(per_step[kernel] > 0, f"phase N's steps launched no {kernel}")
    check(q8 > 0, "phase N ran no int8 product")
    check(native_snapshot() == before, "native/ changed in phase N")
    numbers = {
        "card": card, "build_s": build_s, "convert_s": convert_s,
        "sequences": converted, "store_mb": store_mb,
        "native_ms_per_batch": statistics.median(native_gaps),
        "thread_ms_per_batch": statistics.median(thread_gaps),
        "native_ms_per_batch_mean": statistics.mean(native_gaps),
        "thread_ms_per_batch_mean": statistics.mean(thread_gaps),
        "native_gaps_ms": native_gaps, "thread_gaps_ms": thread_gaps,
        "cli_s": run_s, "step_ms": watch.epochs[0]["seconds"] / 2 * 1e3,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "q8_products": q8}
    print(f"N phase: .vcb conversion of {sum(converted.values())} "
          f"sequences ({store_mb:.0f} MB) in {convert_s:.1f} s; a batch of "
          f"B={TRAIN_BATCH}, bucket {TRAIN_SEQ} assembled in "
          f"{numbers['native_ms_per_batch']:.1f} ms (C++ loader) against "
          f"{numbers['thread_ms_per_batch']:.1f} ms (DataPipeline), host "
          f"clock, median over 3 epochs (means "
          f"{numbers['native_ms_per_batch_mean']:.1f} and "
          f"{numbers['thread_ms_per_batch_mean']:.1f}), byte-equal; "
          f"cli.train.main "
          f"--native_loader --quant int8 in {run_s:.1f} s, "
          f"{numbers['step_ms']:.1f} ms a step (host clock around the "
          f"epoch), launches a step {numbers['launches_per_step']}, {q8} "
          f"int8 products; native/ untouched", flush=True)
    print(json.dumps({"phase_n": numbers}), flush=True)
    return launches


def q8_integers_on_card():
    """The int8 path's integers on the card equal the CPU's on the same
    inputs: the scales and int8 values of an activation and a weight at
    the flagship's patch embedding (1,024 -> 512), and the int32 products
    at that shape and at ones torch._int_mm does not take unpadded."""
    import torch

    from videocad_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(7)
    for m, k, n in ((350, 1024, 512), (7, 1024, 512), (50, 20, 13),
                    (16, 64, 1)):
        x = torch.randn(m, k, generator=gen) * torch.rand(m, 1, generator=gen)
        w = torch.randn(k, n, generator=gen) * 0.05
        on = {}
        for device in ("cuda", "cpu"):
            xs = quant._rowwise_scale(x.to(device), -1)
            ws = quant._rowwise_scale(w.to(device), 0)
            xq, wq = quant._to_int8(x.to(device), xs), quant._to_int8(
                w.to(device), ws)
            on[device] = [t.cpu() for t in (xs, ws, xq, wq,
                                            quant._int_matmul(xq, wq))]
        check(all(torch.equal(a, b) for a, b in zip(on["cuda"], on["cpu"])),
              f"the int8 path's integers differ card vs CPU at "
              f"{(m, k, n)}")


def quant_reference(mode):
    """Float32, depth 2 + 2, TF32 off, dropout 0, under ``quant`` mode, on
    the card and on the CPU.

    A quantized model is a discontinuous function: an ulp of difference
    upstream moves an int8 value across its rounding boundary now and
    then, and what follows moves by a quantization step. So exactness is
    held layer by layer: every quantized dense of one forward and backward
    on the card (its output, dx and dW) against the same layer on the CPU
    fed the card's own x and dy, within 1e-5 of each tensor's largest
    entry (their integer products are exact: q8_integers_on_card). The
    whole step's loss and gradients and the rollout's logits, card against
    CPU, are printed beside the same differences of the card against
    itself with every parameter moved by one ulp, which shows the same
    discontinuity; those are held to be finite only."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.infer.rollout import sequential_inference
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.models.layers import Dense
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          compute_loss_and_metrics,
                                          prepare_model_inputs)

    cfg = dict(flagship_config(), dtype="float32", vit_depth=2,
               num_decoder_layers=2, dropout=0.0, quant=mode)
    data = synthetic_batch_feed(1, 7, image_size=224, seed=3)
    frames, cad = s_frames(1, 6, seed=2, device="cpu")
    loss_config = LossConfig(REFERENCE_CMD_WEIGHTS)

    def step(device, nudge=False, record=None):
        """(loss, gradients, rollout logits) of the model from seed 3;
        ``nudge`` moves every parameter by one ulp; ``record`` keeps each
        quantized dense's (x, y, dy, dx) of the step."""
        model = create_model(cfg, device=device,
                             generator=torch.Generator().manual_seed(3))
        if nudge:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                    p.mul_((1 + sign * 2.0 ** -23).to(device))
        logits = [x.cpu() for x in sequential_inference(
            model, frames.to(device), cad.to(device))]
        hooks = []
        if record is not None:
            for name, m in model.named_modules():
                if isinstance(m, Dense) and m.quant != "none":
                    record[name] = [m]
                    hooks.append(m.register_forward_hook(
                        lambda m, args, out, n=name: record[n].extend(
                            [args[0].detach().cpu(), out.detach().cpu()])))
                    hooks.append(m.register_full_backward_hook(
                        lambda m, gin, gout, n=name: record[n].extend(
                            [gout[0].cpu(), None if gin[0] is None
                             else gin[0].cpu()])))
        inputs, targets = prepare_model_inputs(
            {k: torch.from_numpy(v).to(device) for k, v in data.items()})
        model.train()
        loss = compute_loss_and_metrics(*model(inputs), targets,
                                        loss_config)[0]
        loss.backward()
        for hook in hooks:
            hook.remove()
        return loss.item(), {n: p.grad.cpu() for n, p in
                             model.named_parameters()}, logits

    def differences(a, b):
        worst = max((g - a[1][n]).abs().max().item()
                    / max(a[1][n].abs().max().item(), 1e-30)
                    for n, g in b[1].items() if not n.endswith(".key.bias"))
        return {"loss": abs(a[0] - b[0]), "grad": worst,
                "logits": [(x - y).abs().max().item()
                           for x, y in zip(a[2], b[2])],
                "actions_equal": all(torch.equal(x.argmax(-1), y.argmax(-1))
                                     for x, y in zip(a[2], b[2]))}

    record = {}
    card = step("cuda", record=record)
    cpu = step("cpu")
    nudged = step("cuda", nudge=True)
    check(all(math.isfinite(x[0]) for x in (card, cpu, nudged))
          and all(bool(torch.isfinite(g).all()) for g in card[1].values()),
          f"quant {mode}: a loss or a gradient is not finite")
    # Layer by layer: the CPU's dense on the card's x and dy.
    layer_err = {}
    for name, (module, x, y, dy, dx) in record.items():
        twin = Dense(module.weight.shape[1], module.weight.shape[0],
                     use_bias=module.bias is not None, quant=mode)
        twin.load_state_dict({k: v.cpu() for k, v in
                              module.state_dict().items()})
        xin = x.clone().requires_grad_(dx is not None)
        out = twin(xin)
        out.backward(dy)
        pairs = [(out.detach(), y), (twin.weight.grad, card[1][name +
                                                               ".weight"])]
        if dx is not None:
            pairs.append((xin.grad, dx))
        layer_err[name] = max((got - want).abs().max().item()
                              / max(want.abs().max().item(), 1e-30)
                              for got, want in pairs)
    worst_layer = max(layer_err, key=layer_err.get)
    across, itself = differences(cpu, card), differences(card, nudged)
    print(f"Q reference: quant {mode}, float32 (depth 2+2, dropout 0): "
          f"{len(layer_err)} quantized dense layers, card vs CPU on the "
          f"card's x and dy: output, dx, dW within "
          f"{layer_err[worst_layer]:.3g} of their largest entry (worst "
          f"{worst_layer}; tol 1e-5); the whole step card vs CPU {across}; "
          f"the card against itself with every parameter moved one ulp "
          f"{itself}", flush=True)
    check(len(layer_err) > 0 and layer_err[worst_layer] <= 1e-5,
          f"quant {mode}: the card's {worst_layer} differs from the CPU's "
          f"by {layer_err[worst_layer]} of its largest entry")
    return {"layers": len(layer_err), "layer_err": layer_err[worst_layer],
            "card_vs_cpu": across, "card_vs_card_one_ulp": itself}


def phase_q(counters, train_a):
    """Phase Q: the flagship at full width (bf16, dropout 0.1, B=8, T=192)
    under quant "int8" and "int8_bwd": 1 warm-up and 3 timed train steps,
    finite losses and gradients, the int8 products counted; then the
    integers and the float32 model card against CPU. Returns the launches
    of the full-width steps."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.ops import quant

    batch = to_card(synthetic_batch_feed(TRAIN_BATCH, TRAIN_SEQ,
                                         image_size=224, seed=0))
    numbers = {"train_a_step_ms": train_a["step_ms"],
               "train_a_peak_gb": train_a["peak_gb"]}
    for reset in counters.values():
        reset(0)                      # phase Q's path starts here
    for mode in ("int8", "int8_bwd"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = create_model(dict(flagship_config(), quant=mode),
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
        losses, step_ms, _, counted = train_once(
            model, batch, 4, marks=lambda: (quant._q8_dot.launches,))
        check(all(math.isfinite(x) for x in losses),
              f"quant {mode}: losses {losses}")
        grads = [p.grad for p in model.parameters()]
        check(all(g is not None and bool(torch.isfinite(g).all())
                  for g in grads),
              f"quant {mode}: a gradient is missing or not finite")
        per_step = [c[0] for c in counted]
        check(min(per_step) > 0, f"quant {mode}: no int8 product launched")
        numbers[mode] = {"step_ms": statistics.mean(step_ms[1:]),
                         "step_ms_all": step_ms, "losses": losses,
                         "q8_products_per_step": per_step[-1],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"Q phase: quant {mode}, flagship bf16 dropout {RATE}, "
              f"B={TRAIN_BATCH} T={TRAIN_SEQ}: step ms {step_ms[1:]} (mean "
              f"{numbers[mode]['step_ms']:.1f}; train A "
              f"{train_a['step_ms']:.1f} at B={train_a['batch']}); losses "
              f"{[round(x, 4) for x in losses]}; {per_step[-1]} int8 "
              f"products a step; peak {numbers[mode]['peak_gb']:.2f} GB",
              flush=True)
        del model
    launches = {k: read() for k, read in counters.items()}  # and ends here
    torch.cuda.empty_cache()
    q8_integers_on_card()
    for mode in ("int8", "int8_bwd"):
        numbers[mode]["reference"] = quant_reference(mode)
    print(json.dumps({"phase_q": numbers}), flush=True)
    return launches


def phase_rm(counters, fa, train_a):
    """Phase RM: the flagship at full width (bf16, dropout 0.1, B=8,
    T=192), 1 + 3 train steps with remat_encoder and the same steps
    without it from the same weights and seed: K1 18 + 12 launches a step
    with remat (the state encoder's forward twice), all of its tensor-core
    variant; losses, gradients and parameters bit-equal; the peak memory
    below train A's. Then an eval forward with frame_chunk 191 (8 chunks
    of the 1,528 frames) against the unchunked one. Returns the launches
    of the remat steps."""
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.train import prepare_model_inputs

    batch = to_card(synthetic_batch_feed(TRAIN_BATCH, TRAIN_SEQ,
                                         image_size=224, seed=0))
    k1 = lambda: (fa.mhsa_short.launches, fa.mhsa_short_backward.launches,  # noqa: E731
                  fa.mhsa_short.tc_launches,
                  fa.mhsa_short_backward.tc_launches)
    runs = {}
    launches = None
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = create_model(dict(flagship_config(), remat_encoder=remat),
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
        if remat:
            for reset in counters.values():
                reset(0)              # phase RM's path starts here
        losses, step_ms, _, counted = train_once(model, batch, 4, marks=k1)
        if remat:
            launches = {k: read() for k, read in counters.items()}
        runs[remat] = {
            "losses": losses, "step_ms": statistics.mean(step_ms[1:]),
            "step_ms_all": step_ms, "k1": counted[-1],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in
                       model.named_parameters()}}
        want = (18, 12, 18, 12) if remat else (12, 12, 12, 12)
        check(all(c == want for c in counted),
              f"remat_encoder {remat}: K1 launches a step (forward, "
              f"backward, their tensor-core variant) {counted}, expected "
              f"{want}")
        del model
    plain, remat = runs[False], runs[True]
    grad_diff = max((remat["grads"][n].float() - g.float()).abs().max()
                    .item() for n, g in plain["grads"].items())
    param_diff = max((remat["params"][n] - p).abs().max().item()
                     for n, p in plain["params"].items())
    bit_equal = (plain["losses"] == remat["losses"] and grad_diff == 0
                 and param_diff == 0)
    print(f"RM phase: remat_encoder, flagship bf16 dropout {RATE}, "
          f"B={TRAIN_BATCH} T={TRAIN_SEQ}: step ms {remat['step_ms']:.1f} "
          f"(without remat {plain['step_ms']:.1f}; train A "
          f"{train_a['step_ms']:.1f}); peak {remat['peak_gb']:.2f} GB "
          f"(without {plain['peak_gb']:.2f}; train A "
          f"{train_a['peak_gb']:.2f}); K1 a step {remat['k1']}; losses "
          f"{remat['losses']} vs {plain['losses']}; bit-equal: {bit_equal} "
          f"(largest gradient difference {grad_diff:.3g}, parameter "
          f"{param_diff:.3g})", flush=True)
    check(bit_equal, f"remat_encoder changed the steps: losses "
          f"{remat['losses']} vs {plain['losses']}, gradients by "
          f"{grad_diff}, parameters by {param_diff}")
    check(remat["peak_gb"] < train_a["peak_gb"]
          and remat["peak_gb"] < plain["peak_gb"],
          f"remat_encoder's peak {remat['peak_gb']:.2f} GB is not below "
          f"train A's {train_a['peak_gb']:.2f} GB and the step's without "
          f"remat {plain['peak_gb']:.2f} GB")

    # frame_chunk: the eval forward in 8 chunks of 191 frames.
    torch.cuda.empty_cache()
    chunked = create_model(dict(flagship_config(), frame_chunk=TRAIN_SEQ - 1),
                           device="cuda",
                           generator=torch.Generator().manual_seed(0))
    whole = create_model(flagship_config(), device="cuda",
                         generator=torch.Generator().manual_seed(0))
    inputs, _ = prepare_model_inputs(batch)
    check(inputs["frames"].shape[:2] == (TRAIN_BATCH, TRAIN_SEQ - 1),
          f"frames {tuple(inputs['frames'].shape)}")
    outs, peaks, k1_fwd = {}, {}, {}
    for label, model in (("whole", whole), ("chunked", chunked)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mark = fa.mhsa_short.launches
        with torch.no_grad():
            outs[label] = [x.float() for x in model(inputs)]
        torch.cuda.synchronize()
        k1_fwd[label] = fa.mhsa_short.launches - mark
        peaks[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(k1_fwd == {"whole": 12, "chunked": 6 * TRAIN_BATCH + 6},
          f"K1 forward launches of the eval forward {k1_fwd}")
    errs = []
    for got, want in zip(outs["chunked"], outs["whole"]):
        scale = want.abs().max().item()
        diff = (got - want).abs()
        errs.append((diff.max().item() / scale, diff.mean().item() / scale))
    same_cmd = (outs["chunked"][0].argmax(-1) == outs["whole"][0].argmax(-1)
                ).float().mean().item()
    print(f"RM phase: frame_chunk {TRAIN_SEQ - 1}, eval forward of "
          f"{TRAIN_BATCH * (TRAIN_SEQ - 1)} frames in {TRAIN_BATCH} chunks: "
          f"logits within {errs} (max, mean) of their largest entry of the "
          f"unchunked forward's (tol 2e-2, 1e-3); argmax commands equal on "
          f"{same_cmd:.4f}; activation peak {peaks['chunked']:.2f} GB "
          f"(unchunked {peaks['whole']:.2f} GB); K1 forward launches "
          f"{k1_fwd}", flush=True)
    check(all(m <= 2e-2 and a <= 1e-3 for m, a in errs),
          f"frame_chunk's logits differ from the unchunked ones: {errs}")
    print(json.dumps({"phase_rm": {
        "step_ms": remat["step_ms"], "step_ms_plain": plain["step_ms"],
        "peak_gb": remat["peak_gb"], "peak_gb_plain": plain["peak_gb"],
        "train_a": train_a, "k1_per_step": remat["k1"],
        "bit_equal": bit_equal, "chunk_errs": errs,
        "chunk_peak_gb": peaks, "chunk_cmd_agreement": same_cmd}}),
          flush=True)
    del chunked, whole
    torch.cuda.empty_cache()
    return launches


def phase_w(root):
    """Phase W: a reference-named state dict at the flagship's widths from
    seed 0, in both vit_pytorch generations, saved as .pt; Experiment with
    a state_dict naming it builds the generation detect_config_overrides
    names, with the source's weights bit for bit and the logits of a model
    given state_dict_from_jax(convert_state_dict(sd)) directly."""
    import torch

    from videocad_tpu_torch import experiment
    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.models.convert import (jax_tree_from_state_dict,
                                                   state_dict_from_jax)
    from videocad_tpu_torch.models.factory import create_model, flagship_config
    from videocad_tpu_torch.models.torch_checkpoint import (
        convert_state_dict, detect_config_overrides, reference_state_dict)
    from videocad_tpu_torch.train import prepare_model_inputs

    built = []

    class Recorder:
        """Keeps the model the experiment built; trains nothing."""

        def __init__(self, model, *args, **kwargs):
            built.append(model)

        def train(self, epochs):
            pass

        def evaluate(self, mode="test"):
            return {}

    inputs, _ = prepare_model_inputs(to_card(synthetic_batch_feed(
        2, 8, image_size=224, seed=4)))
    numbers = {}
    for generation, overrides in (
            ("modern", {}),
            ("legacy", {"vit_patch_norm": False, "vit_final_norm": False})):
        cfg = dict(flagship_config(), **overrides)
        source = create_model(cfg, generator=torch.Generator().manual_seed(0))
        sd = {"module." + k: torch.from_numpy(v) for k, v in
              reference_state_dict(jax_tree_from_state_dict(
                  source.state_dict())).items()}
        path = os.path.join(root, f"reference_{generation}.pt")
        start = time.monotonic()
        torch.save({"model_state_dict": sd, "epoch": 0}, path)
        save_s = time.monotonic() - start
        check(detect_config_overrides(sd) == overrides,
              f"{generation}: detected {detect_config_overrides(sd)}")
        log_dir = os.path.join(root, f"logs_w_{generation}")
        built.clear()
        saved, experiment.Trainer = experiment.Trainer, Recorder
        start = time.monotonic()
        try:
            experiment.Experiment(
                None, None, None, {"epochs": 0}, device="cuda",
                log_dir=log_dir).run_with_params(
                dict(flagship_config(), state_dict=path), "w")
        finally:
            experiment.Trainer = saved
        load_s = time.monotonic() - start
        (model,) = built
        for key, value in overrides.items():
            check(getattr(model.config, key) is value,
                  f"{generation}: the experiment built {key}="
                  f"{getattr(model.config, key)}")
        (run,) = os.listdir(log_dir)
        with open(os.path.join(log_dir, run, "params.json")) as f:
            written = json.load(f)
        check(all(written.get(k) is v for k, v in overrides.items()),
              f"{generation}: params.json lacks the overrides")
        mine = model.state_dict()
        check(sorted(mine) == sorted(source.state_dict())
              and all(torch.equal(mine[k].cpu(), v)
                      for k, v in source.state_dict().items()),
              f"{generation}: the warm-started weights are not the source's")
        direct = create_model(cfg, device="cuda")
        direct.load_state_dict(state_dict_from_jax(
            convert_state_dict(sd, cfg)))
        with torch.no_grad():
            got = model.eval()(inputs)
            want = direct.eval()(inputs)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{generation}: the experiment's logits differ from the "
              "directly converted model's")
        numbers[generation] = {"save_s": save_s, "experiment_s": load_s,
                               "pt_mb": os.path.getsize(path) / 1e6}
        print(f"W phase: {generation} reference checkpoint "
              f"({numbers[generation]['pt_mb']:.0f} MB, saved in "
              f"{save_s:.1f} s): Experiment built "
              f"{overrides or 'the modern ViT'} in {load_s:.1f} s, weights "
              f"bit-equal to the source, logits equal to the direct "
              f"conversion's", flush=True)
        del model, direct, source
        built.clear()
        os.remove(path)
    torch.cuda.empty_cache()
    print(json.dumps({"phase_w": numbers}), flush=True)


def kernel_entry(name, replaces, launches, rows, pick, extra):
    """One entry of the kernels line: the times at the train step's shape,
    the largest error over all checks."""
    row = next(r for r in rows if r["kernel"] == name and pick(r))
    source = ("mhsa_short.cu" if name.startswith("mhsa")
              else "flash_attention.cu" if name.startswith("flash")
              else "layernorm.cu" if name.startswith("layer_norm")
              else "dropout.cu" if name == "hw_dropout"
              else "fused_block.cu" if name in BLOCK_KERNELS
              else "gray_normalize.cu")
    entry = {"name": name, "route": "cuda",
             "source": "videocad_tpu_torch/csrc/" + source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows
                                if r["kernel"] == name),
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "library_ms": row.get("library_ms")}
    entry.update(extra(row))
    entry["checks"] = [r for r in rows if r["kernel"] == name]
    return entry


def flash_entries(rows, launches):
    """The kernels line's three K3 entries: the decoder's self-attention
    (causal) with dropout, as the train step runs it, with the banded
    cross-attention's times, the rate-0 times, the scalar kernels' on the
    same inputs and the times at the ViT's shape (K1's beside them)."""
    same = lambda r: {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}  # noqa: E731
    flash_at = lambda kind: lambda r: (  # noqa: E731
        (r["batch"], r["q_len"], r["d"]) == (FLASH_SHAPE[0], FLASH_SHAPE[1],
                                             FLASH_SHAPE[3])
        and r["dtype"] == "bfloat16" and r["mask"] == kind
        and r["rate"] == RATE)
    flash_rate0 = lambda kind: lambda r: (  # noqa: E731
        flash_at(kind)(dict(r, rate=RATE)) and r["rate"] == 0.0)
    flash_vit = lambda rate: lambda r: (  # noqa: E731
        r["batch"] == TRAIN_FRAMES and r["rate"] == rate)
    flash = []
    for name, line in zip(FLASH_KERNELS, (108, 173, 206)):
        entry = kernel_entry(name, f"videocad_tpu/ops/attention.py:{line}",
                             launches[name], rows, flash_at("causal"), same)
        row = next(r for r in rows if r["kernel"] == name
                   and flash_at("causal")(r))
        entry.update(variant=row["variant"], scalar_ms=row["scalar_ms"],
                     device_ms=row["device_ms"],
                     library_device_ms=row["library_device_ms"],
                     roofline_share=row["bound_ms"] / row["device_ms"],
                     tc_launches=launches[name + "_tc"])
        for suffix, pick in (("_band", flash_at("band")),
                             ("_rate0", flash_rate0("causal")),
                             ("_band_rate0", flash_rate0("band")),
                             ("_vit", flash_vit(RATE)),
                             ("_vit_rate0", flash_vit(0.0))):
            other = next(r for r in rows if r["kernel"] == name and pick(r))
            entry.update({key + suffix: other.get(key) for key in (
                "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "scalar_ms", "k1_ms", "bound_ms")
                if key in other})
        flash.append(entry)
    return flash


def attention_bound(tensors, flops_per_cell):
    """The bound of an attention kernel that moves ``tensors`` (B, T, H*D)
    tensors and does ``flops_per_cell`` * T * T * D flops per head."""
    def extra(row):
        cells = row["batch"] * HEADS * SEQ * SEQ * (WIDTH // HEADS)
        itemsize = 2 if row["dtype"] == "bfloat16" else 4
        return bound(tensors * row["batch"] * SEQ * WIDTH * itemsize,
                     flops_per_cell * cells, row["dtype"])
    return extra


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check((REPO / "videocad_tpu_torch").is_dir(),
          f"no videocad_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from videocad_tpu_torch.kernels import build
    from videocad_tpu_torch.ops import attention as fl
    from videocad_tpu_torch.ops import dropout as dr
    from videocad_tpu_torch.ops import fused_attention as fa
    from videocad_tpu_torch.ops import fused_block as fb
    from videocad_tpu_torch.ops import layernorm as ln
    from videocad_tpu_torch.ops import preprocess as pp
    from videocad_tpu_torch.ops import prng

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.monotonic()
    names = build.build_all()
    for module in (fa, pp, ln, dr, fl, fb):
        module.load_library()
    print(f"build: {names} in {time.monotonic() - start:.1f} s", flush=True)
    for name in names:
        seconds, log = build.build_log.get(name, (0.0, "(cached)"))
        print(f"build: {name}.cu nvcc {seconds:.1f} s\n{log.strip()}",
              flush=True)

    rows = phase_forward(fa) + phase_forward_dropout(fa, prng)
    rows += phase_backward(fa, prng)
    phase_mask(fa)
    start = time.monotonic()
    rows += phase_k1_wide(fa, prng)
    torch.cuda.empty_cache()
    print(f"K1 wide phase: {time.monotonic() - start:.1f} s", flush=True)
    rows += phase_gray(pp)
    rows += phase_layer_norm(ln)
    rows += phase_hw_dropout(dr)
    rows += phase_flash(fl, fa, prng)
    torch.cuda.empty_cache()
    rows += phase_block(fb, prng)
    torch.cuda.empty_cache()

    # name -> (the function that carries the count, the count's attribute);
    # counter(name)() reads a count, counter(name)(0) sets it.
    counted = {
        "mhsa_short": (fa.mhsa_short, "launches"),
        "mhsa_short_bwd": (fa.mhsa_short_backward, "launches"),
        # Of those, the launches of the wide instantiation (T past 64).
        "mhsa_short_wide": (fa.mhsa_short, "wide_launches"),
        "mhsa_short_bwd_wide": (fa.mhsa_short_backward, "wide_launches"),
        "gray_normalize": (pp.grayscale_normalize_fused, "launches"),
        "gray_resize_normalize": (pp.grayscale_normalize_fused,
                                  "resize_launches"),
        "layer_norm_fwd": (ln.layer_norm, "launches"),
        "layer_norm_bwd": (ln.layer_norm_backward, "launches"),
        # Of the forward's and the backward's, those of the flagship's two
        # exact-width kernels.
        "layer_norm_fwd_bf16_512": (ln.layer_norm.variant_launches,
                                    "bfloat16/512"),
        "layer_norm_fwd_bf16_1024": (ln.layer_norm.variant_launches,
                                     "bfloat16/1024"),
        "layer_norm_bwd_bf16_512": (ln.layer_norm_backward.variant_launches,
                                    "bfloat16/512"),
        "layer_norm_bwd_bf16_1024": (ln.layer_norm_backward.variant_launches,
                                     "bfloat16/1024"),
        "hw_dropout": (dr.hw_dropout, "launches"),
        "flash_attention": (fl.flash_attention, "launches"),
        "flash_attention_dq": (fl.flash_attention_dq, "launches"),
        "flash_attention_dkv": (fl.flash_attention_dkv, "launches"),
        # Of those, the launches of the tensor-core variant.
        "flash_attention_tc": (fl.flash_attention, "tc_launches"),
        "flash_attention_dq_tc": (fl.flash_attention_dq, "tc_launches"),
        "flash_attention_dkv_tc": (fl.flash_attention_dkv, "tc_launches"),
        "attn_block": (fb.attn_block, "launches"),
        "attn_block_bwd": (fb.attn_block_backward, "launches"),
        # Of those, the launches of the tensor-core variant.
        "attn_block_tc": (fb.attn_block, "tc_launches"),
        "attn_block_bwd_tc": (fb.attn_block_backward, "tc_launches"),
        "mlp_block": (fb.mlp_block, "launches"),
        "mlp_block_bwd": (fb.mlp_block_backward, "launches"),
        "mlp_block_tc": (fb.mlp_block, "tc_launches"),
        "mlp_block_bwd_tc": (fb.mlp_block_backward, "tc_launches"),
    }

    def counter(name):
        holder, attr = counted[name]
        if isinstance(holder, dict):
            return lambda *value: (holder.__setitem__(attr, value[0])
                                   if value else holder[attr])
        return lambda *value: (setattr(holder, attr, value[0]) if value
                               else getattr(holder, attr))

    counters = {name: counter(name) for name in counted}
    for reset in counters.values():
        reset(0)                          # the first main path starts here
    engine = phase_serve(fa, np)
    phase_rollout(fa, engine)
    del engine
    torch.cuda.empty_cache()
    train_a = phase_train_a(fa)
    torch.cuda.empty_cache()
    phase_train_b(pp)
    launches = {name: read() for name, read in counters.items()}
    torch.cuda.empty_cache()             # the first main path ends here
    # Train C's dataset on disk serves train D and the evaluation too.
    root = tempfile.mkdtemp(prefix="videocad_smoke_")
    try:
        launches_c, dataset_argv = phase_train_c(counters, card, root)
        torch.cuda.empty_cache()
        launches_d, model_argv, peak_d_gb = phase_train_d(
            counters, card, root, dataset_argv)
        torch.cuda.empty_cache()
        launches_eval = phase_evaluate(counters, root, dataset_argv,
                                       model_argv)
        torch.cuda.empty_cache()
        launches_e = phase_train_e(counters, card, root, dataset_argv,
                                   peak_d_gb)
        torch.cuda.empty_cache()
        launches_named = phase_named(counters, fa, np)
        launches_s = phase_s(counters, fa, np)
        # The last single-card options of the training entry point; N
        # reads train C's dataset.
        start = time.monotonic()
        launches_n = phase_n(counters, card, root, dataset_argv)
        torch.cuda.empty_cache()
        print(f"N phase: {time.monotonic() - start:.1f} s", flush=True)
        start = time.monotonic()
        launches_q = phase_q(counters, train_a)
        print(f"Q phase: {time.monotonic() - start:.1f} s", flush=True)
        start = time.monotonic()
        launches_rm = phase_rm(counters, fa, train_a)
        print(f"RM phase: {time.monotonic() - start:.1f} s", flush=True)
        start = time.monotonic()
        phase_w(root)
        print(f"W phase: {time.monotonic() - start:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # The path each kernel is claimed on: train E for the fused sub-block
    # kernels, train D for the flash attention kernels, train C for the
    # kernels behind ln_impl and dropout_impl, GenCAD's (G) for K1's wide
    # instantiation, the first path for the others.
    by_path = {name: {"serve_rollout_train_ab": launches[name],
                      "train_c": launches_c[name],
                      "train_d": launches_d[name],
                      "evaluate": launches_eval[name],
                      "train_e": launches_e[name],
                      **{phase: counts[name]
                         for phase, counts in launches_named.items()},
                      "S": launches_s[name], "N": launches_n[name],
                      "Q": launches_q[name], "RM": launches_rm[name]}
               for name in counters}
    print(f"main path launches: {by_path}", flush=True)
    launches = {name: launches_e[name]
                if name.startswith(("attn_block", "mlp_block"))
                else launches_d[name] if name.startswith("flash")
                else launches_c[name] if name.startswith(("layer_norm",
                                                          "hw_dropout"))
                else launches_named["G"][name] if name.endswith("_wide")
                else launches[name] for name in counters}
    for name in counters:
        check(launches[name] > 0,
              f"the main path of the {name} kernel did not launch it")
    check(launches_eval["flash_attention"] > 0,
          "the evaluation launched no flash attention forward")

    start = time.monotonic()
    phase_reference()
    phase_reference_train()
    phase_reference_train(ln_impl="pallas", dropout_impl="pallas")
    phase_reference_train(**ALL_PALLAS)
    phase_reference_train(**BLOCK)
    phase_reference_train(**dict(ALL_PALLAS, vit_attention_impl="pallas"))
    phase_reference_train(vit_attention_impl="fused", vit_mlp_impl="block")
    for phase in NAMED:
        phase_reference_named(phase)
    print(f"reference phase: {time.monotonic() - start:.1f} s", flush=True)

    at_train = lambda r: (r["batch"] == TRAIN_FRAMES  # noqa: E731
                          and r["dtype"] == "bfloat16")
    pick_train = lambda r: at_train(r) and r["rate"] == RATE  # noqa: E731
    fwd = kernel_entry(
        "mhsa_short", "videocad_tpu/ops/fused_attention.py:110",
        launches["mhsa_short"], rows, pick_train, attention_bound(4, 4))
    bwd = kernel_entry(
        "mhsa_short_bwd", "videocad_tpu/ops/fused_attention.py:129",
        launches["mhsa_short_bwd"], rows, pick_train, attention_bound(7, 10))
    # The times above are with dropout 0.1, as the train step runs it; the
    # same without dropout, as serving and the rollout run it; the scalar
    # kernel's beside them.
    for entry in (fwd, bwd):
        with_dropout, without = (next(
            r for r in rows if r["kernel"] == entry["name"] and at_train(r)
            and r["rate"] == rate) for rate in (RATE, 0.0))
        entry.update(variant=with_dropout["variant"],
                     roofline_share=with_dropout["roofline_share"],
                     scalar_ms=with_dropout["scalar_ms"],
                     ms_rate0=without["ms"],
                     plain_ms_rate0=without["plain_ms"],
                     library_ms_rate0=without["library_ms"],
                     scalar_ms_rate0=without["scalar_ms"])
    same = lambda r: {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}  # noqa: E731
    # K1's wide instantiation at T = 65, as GenCAD's train step runs it (the
    # CAD encoder: B = 8, dropout 0.1); a session's B = 1 and 1,528 frames
    # beside it.
    wide = []
    for name, line in (("mhsa_short_wide", 110), ("mhsa_short_bwd_wide", 129)):
        at = lambda b, rate: lambda r: (  # noqa: E731
            r["batch"] == b and r["dtype"] == "bfloat16" and r["rate"] == rate)
        entry = kernel_entry(name, f"videocad_tpu/ops/fused_attention.py:"
                             f"{line}", launches[name], rows, at(8, RATE),
                             same)
        row = next(r for r in entry["checks"] if at(8, RATE)(r))
        entry.update(variant=row["variant"], seq=WIDE_SEQ,
                     roofline_share=row["roofline_share"])
        for suffix, b, rate in (("_rate0", 8, 0.0), ("_b1", 1, RATE),
                                ("_b1528", TRAIN_FRAMES, RATE),
                                ("_b1528_rate0", TRAIN_FRAMES, 0.0)):
            other = next(r for r in entry["checks"] if at(b, rate)(r))
            entry.update({key + suffix: other[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms",
                "roofline_share")})
        wide.append(entry)
    gray = kernel_entry(
        "gray_normalize", "videocad_tpu/ops/preprocess.py:153",
        launches["gray_normalize"], rows, lambda r: True, same)
    resize = kernel_entry(
        "gray_resize_normalize", "videocad_tpu/ops/preprocess.py:167",
        launches["gray_resize_normalize"], rows, lambda r: True, same)
    ln_at = lambda shape: lambda r: (  # noqa: E731
        (r["rows"], r["d"]) == shape and r["dtype"] == "bfloat16")
    ln_fwd = kernel_entry(
        "layer_norm_fwd", "videocad_tpu/ops/layernorm.py:43",
        launches["layer_norm_fwd"], rows, ln_at(LN_SHAPES[0]), same)
    ln_bwd = kernel_entry(
        "layer_norm_bwd", "videocad_tpu/ops/layernorm.py:51",
        launches["layer_norm_bwd"], rows, ln_at(LN_SHAPES[0]), same)
    drop_at = lambda shape: lambda r: (  # noqa: E731
        tuple(r["shape"]) == shape and r["dtype"] == "bfloat16")
    drop = kernel_entry(
        "hw_dropout", "videocad_tpu/ops/dropout.py:32",
        launches["hw_dropout"], rows, drop_at(DROPOUT_SHAPES[0]), same)
    # Both clocks for K4 and K5, and the host's cost of a call (host clock
    # minus device time), at the train step's shape and at the small one
    # (the CAD encoder's rows, the decoder's attention weights).
    clocks = ("device_ms", "library_device_ms", "host_ms", "library_host_ms")
    for entry, large, small in (
            (ln_fwd, ln_at(LN_SHAPES[0]), ln_at(LN_SHAPES[2])),
            (ln_bwd, ln_at(LN_SHAPES[0]), ln_at(LN_SHAPES[2])),
            (drop, drop_at(DROPOUT_SHAPES[0]), drop_at(DROPOUT_SHAPES[1]))):
        row = next(r for r in entry["checks"] if large(r))
        entry.update({key: row[key] for key in clocks + ("roofline_share",)})
        row = next(r for r in entry["checks"] if small(r))
        entry.update({key + "_small": row[key]
                      for key in ("ms", "library_ms") + clocks})
    for entry, way in ((ln_fwd, "fwd"), (ln_bwd, "bwd")):
        entry.update(variant=next(r for r in entry["checks"]
                                  if ln_at(LN_SHAPES[0])(r))["variant"],
                     variant_launches={name: launches[name] for name in (
                         f"layer_norm_{way}_bf16_512",
                         f"layer_norm_{way}_bf16_1024")})
    for entry in (gray, resize):
        entry["device_ms"] = entry["checks"][0]["device_ms"]
    flash = flash_entries(rows, launches)
    # The fused sub-block kernels at a train step's frames with dropout;
    # the time of the port's unfused sub-block stands beside them.
    blocks = []
    _, fused_log = build.build_log.get("fused_block", (0.0, ""))
    for name, line in zip(BLOCK_KERNELS, (486, 504, 277, 289)):
        entry = kernel_entry(name, f"videocad_tpu/ops/fused_block.py:{line}",
                             launches[name], rows, pick_train, same)
        row = next(r for r in rows if r["kernel"] == name and pick_train(r))
        entry["unfused_ms"] = row["unfused_ms"]
        # The tensor-core variant's rows: the present kernels' time on
        # the same inputs, the device times beside U's, the rate-0 and
        # small-batch times, registers and spills.
        entry.update({key: row[key] for key in (
            "variant", "tile_ms", "tile_device_ms", "device_ms",
            "unfused_device_ms") if key in row})
        entry["tc_launches"] = launches[name + "_tc"]
        entry["roofline_share"] = row["bound_ms"] / row["device_ms"]
        for suffix, pick in (
                ("_rate0", lambda r: at_train(r) and r["rate"] == 0.0),
                ("_b8", lambda r: r["batch"] == 8
                 and r["dtype"] == "bfloat16" and r["rate"] == RATE),
                ("_b1", lambda r: r["batch"] == 1
                 and r["dtype"] == "bfloat16" and r["rate"] == RATE)):
            other = next(r for r in rows if r["kernel"] == name
                         and pick(r))
            entry.update({key + suffix: other[key] for key in (
                "ms", "device_ms", "tile_ms", "tile_device_ms",
                "unfused_ms", "unfused_device_ms") if key in other})
        kernel = {"attn_block": "attn_fwd_tc_kernel",
                  "attn_block_bwd": "attn_bwd_tc_kernel",
                  "mlp_block": "mlp_fwd_tc_kernel",
                  "mlp_block_bwd": "mlp_bwd_tc_kernel"}[name]
        entry["ptxas"] = {kernel: ptxas_usage(fused_log, kernel)}
        if name.endswith("_bwd"):
            entry["pieces"] = row["pieces"]
            entry["ptxas"]["grad_weight_tc_kernel"] = ptxas_usage(
                fused_log, "grad_weight_tc_kernel")
        print(f"{name}: {entry['ptxas']}", flush=True)
        blocks.append(entry)
    kernels = ([fwd, bwd] + wide + [gray, resize, ln_fwd, ln_bwd, drop]
               + flash + blocks)
    for entry in kernels:
        entry["launches_by_path"] = by_path[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
