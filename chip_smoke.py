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
     the plain forward at float32), the mask's properties, the two
     grayscale kernels, layer_norm forward and backward (also against
     float64), hw_dropout (compared exactly, and its mask's properties),
     and one library call per kernel that has one
     (scaled_dot_product_attention, F.layer_norm and its backward,
     F.dropout) timed beside it as a yardstick that no path uses;
  4. serve: the flagship config at full width in bf16 with seeded random
     weights, through the serving CLI's build_engine, behind the HTTP
     server; three staggered sessions step through ServingClient, some
     steps concurrent;
  5. rollout: sequential_inference on the flagship at B=2, T=187;
  6. train A: the flagship as its JSON has it (bf16, dropout 0.1, fused ViT
     attention), B=8, T=192, 224 x 224 uint8 frames: 1 warm-up and 3 timed
     train steps, the eval loss before and after;
  7. train B: the same config with preprocess_impl "pallas", B=2, T=48, a
     256 x 256 CAD image: 2 train steps and an eval step, the eval loss
     against the plain preprocess path's;
  8. train C: the training entry point, videocad_tpu_torch.cli.train.main,
     on a synthetic dataset written to disk from a seed (32 sequences of
     150-191 frames of 224 x 224 x 3), the flagship with ln_impl and
     dropout_impl "pallas": 2 epochs of 2 steps at B=8 with validation, a
     rollout validation, checkpoints, the test evaluation and test
     rollout; then a second call with --resume for one epoch more. The
     epoch loop must not synchronise the host outside its logging fetch;
     the files of the logs layout must exist; the resumed run must start at
     epoch 2, step 4, with the checkpoint's parameters; the eval loss on
     the test split must fall;
  9. serve from train C's last checkpoint (--checkpoint_folder), one
     session of a few steps over HTTP;
 10. reference: at the flagship's widths in float32, with the depth cut to
     2 + 2 layers, on the card and on the CPU (plain versions): the
     rollout's logits and one train step's loss and gradients compared,
     the train step once more with ln_impl and dropout_impl "pallas".

The kernels' launch counters are set to 0 just before phase 4 and read
after phase 7, and again just before phase 8 and read just after it: each
kernel must have been launched by one of the two paths. The
second-to-last lines are a JSON object of the kernels and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}. Any
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


def in_turns(kernel, plain, **kw):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, **kw) for f in (plain, kernel, kernel,
                                                  plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


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
            got = fa.mhsa_short(q, k, v, None, HEADS)
            torch.cuda.synchronize()
            want = fa.mhsa_short_reference(q, k, v, None, HEADS)
            err = (got.float() - want.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            # Against float64 too: the plain version sums in the same
            # order as the kernel, so their difference alone can be 0.
            f64_err = (got.double() - attention_f64(q, k, v)).abs().max()
            ms, plain_ms = in_turns(
                lambda: fa.mhsa_short(q, k, v, None, HEADS),
                lambda: fa.mhsa_short_reference(q, k, v, None, HEADS))
            row = {"kernel": "mhsa_short", "batch": b, "rate": 0.0,
                   "dtype": dtype_name(dtype), "max_abs_err": max_err,
                   "mean_abs_err": mean_err,
                   "max_abs_err_vs_f64": f64_err.item(), "ms": ms,
                   "plain_ms": plain_ms}
            if b == TRAIN_FRAMES:
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
            (TRAIN_FRAMES, torch.bfloat16, 2e-2, 1e-3),
            (8, torch.float32, 1e-5, 1e-5)]:
        q, k, v = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(3))
        seed = 1000 + b
        with torch.no_grad():
            got = fa.mhsa_short(q, k, v, seed, HEADS, RATE)
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
               "dtype": dtype_name(dtype), "max_abs_err": max_err,
               "mean_abs_err": mean_err, "max_abs_err_vs_f64": f64_err,
               "kept_set_identical": same_set,
               "drop_share": 1.0 - kept.float().mean().item(), "ms": ms,
               "plain_ms": plain_ms}
        if b == TRAIN_FRAMES:
            # The library's call for the same function (its own mask).
            heads = lambda x: x.view(b, SEQ, HEADS, -1).transpose(1, 2)  # noqa: E731
            with torch.no_grad():
                row["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        heads(q), heads(k), heads(v), dropout_p=RATE))
        print(f"mhsa_short {row}", flush=True)
        check(same_set, f"mhsa_short B={b} {dtype} rate {RATE}: the kernel's "
              "kept set is not the plain version's")
        check(math.isfinite(max_err) and max_err <= max_tol
              and mean_err <= mean_tol,
              f"mhsa_short B={b} {dtype} rate {RATE}: max err {max_err} "
              f"(tol {max_tol}), mean err {mean_err} (tol {mean_tol})")
        rows.append(row)
    return rows


def phase_backward(fa, prng):
    """mhsa_short backward against its plain version (float32: 1e-5; bf16:
    2e-2 max, 1e-3 mean) and, at float32, against autograd through the
    plain forward; the error against float64 autograd is printed too."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, dtype, rate in [(b, dtype, rate)
                           for rate in (0.0, RATE)
                           for b, dtype in [(8, torch.bfloat16),
                                            (TRAIN_FRAMES, torch.bfloat16),
                                            (8, torch.float32)]]:
        bf16 = dtype == torch.bfloat16
        max_tol, mean_tol = (2e-2, 1e-3) if bf16 else (1e-5, 1e-5)
        q, k, v, g = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(4))
        seed = 2000 + b if rate else None
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa.mhsa_short_backward.launches
        fa.mhsa_short(*leaves, seed, HEADS, rate).backward(g)
        torch.cuda.synchronize()
        check(fa.mhsa_short_backward.launches == before + 1,
              "autograd did not launch the backward kernel once")
        got = [x.grad for x in leaves]
        with torch.no_grad():
            want = fa.mhsa_short_backward_reference(q, k, v, g, seed, HEADS,
                                                    rate)
        errs = [(a.float() - w.float()).abs() for a, w in zip(got, want)]
        max_err = max(e.max().item() for e in errs)
        mean_err = max(e.mean().item() for e in errs)
        keep = None if not rate else prng.keep_mask(prng.dropout_bits(
            seed, b, HEADS, SEQ, SEQ, device="cuda"), rate)
        f64_err = max((a.double() - w).abs().max().item() for a, w in
                      zip(got, attention_grads_f64(q, k, v, g, keep, rate)))
        del keep
        row = {"kernel": "mhsa_short_bwd", "batch": b, "rate": rate,
               "dtype": dtype_name(dtype), "max_abs_err": max_err,
               "mean_abs_err": mean_err, "max_abs_err_vs_f64": f64_err}
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
        print(f"mhsa_short_bwd {row}", flush=True)
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
    """The mask's properties on the card: the drop share, another seed
    gives another mask, and the backward of a call redraws its forward's
    mask (identity values and an identity output gradient make the forward
    return the dropped weights and dv their transpose)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, dtype = 64, torch.float32
    q, k = (randn((b, SEQ, WIDTH), gen, dtype) for _ in range(2))
    eye = identity_values(b, dtype)
    with torch.no_grad():
        kept = weights_of(fa.mhsa_short(q, k, eye, 31, HEADS, RATE)) > 0
        other = weights_of(fa.mhsa_short(q, k, eye, 32, HEADS, RATE)) > 0
        _, _, dv = fa.mhsa_short_backward(q, k, eye, eye, 31, HEADS, RATE)
    share = 1.0 - kept.float().mean().item()
    kept_bwd = weights_of(dv).transpose(-1, -2) > 0
    print(f"mask: drop share {share:.5f} over B={b} (rate {RATE}); seeds "
          f"differ: {not torch.equal(kept, other)}; backward redraws the "
          f"forward's mask: {torch.equal(kept, kept_bwd)}", flush=True)
    check(abs(share - RATE) <= 0.002, f"drop share {share} is not {RATE}")
    check(not torch.equal(kept, other), "two seeds drew one mask")
    check(torch.equal(kept, kept_bwd),
          "the backward did not redraw the forward's mask")


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
        ms, plain_ms = in_turns(
            lambda: pp.grayscale_normalize_fused(images, True, target),
            lambda: pp.grayscale_normalize(images, True, target))
        row = {"kernel": name, "shape": list(shape), "max_abs_err": max_err,
               "max_abs_err_vs_f64": f64_err.item(), "ms": ms,
               "plain_ms": plain_ms}
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

        with torch.no_grad():
            got = ln.layer_norm(x, scale, bias, LN_EPS)
            torch.cuda.synchronize()
            want = ln.layer_norm_plain(x, scale, bias, LN_EPS)
            max_err, max_ulps = errors(got, want)
            exact = layer_norm_f64(x, scale, bias)
            f64_err = (got.double() - exact).abs().max().item()
            del exact
            lib_scale, lib_bias = scale.to(dtype), bias.to(dtype)
            ms, plain_ms = in_turns(
                lambda: ln.layer_norm(x, scale, bias, LN_EPS),
                lambda: ln.layer_norm_plain(x, scale, bias, LN_EPS))
            library_ms = cuda_ms(lambda: F.layer_norm(
                x, (d,), lib_scale, lib_bias, LN_EPS))
        row = {"kernel": "layer_norm_fwd", "rows": n, "d": d,
               "dtype": dtype_name(dtype), "max_abs_err": max_err,
               "max_err_ulps": max_ulps, "max_abs_err_vs_f64": f64_err,
               "tolerance": "1 ulp of bf16" if bf16 else "1e-5",
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        row.update(bound(2 * n * d * itemsize + 8 * d, 8.0 * n * d,
                         "float32"))
        print(f"layer_norm_fwd {row}", flush=True)
        check(math.isfinite(max_err)
              and (max_ulps <= 1.0 if bf16 else max_err <= 1e-5),
              f"layer_norm_fwd {n}x{d} {dtype}: max err {max_err} "
              f"({max_ulps} ulps)")
        check(f64_err <= (0.05 if bf16 else 1e-5),
              f"layer_norm_fwd {n}x{d} {dtype}: {f64_err} from float64")
        rows.append(row)
        del got, want

        # Backward, through autograd: one launch of the backward kernel.
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        before = ln.layer_norm_backward.launches
        ln.layer_norm(*leaves, LN_EPS).backward(g)
        torch.cuda.synchronize()
        check(ln.layer_norm_backward.launches == before + 1,
              "autograd did not launch the LayerNorm backward once")
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
        with torch.no_grad():
            ms, plain_ms = in_turns(
                lambda: ln.layer_norm_backward(x, scale, g, LN_EPS),
                lambda: ln.layer_norm_backward_plain(x, scale, g, LN_EPS))
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, lib, g, retain_graph=True))
        del lib, lib_out
        row = {"kernel": "layer_norm_bwd", "rows": n, "d": d,
               "dtype": dtype_name(dtype), "max_abs_err": max_err,
               "max_err_ulps": max_ulps, "max_abs_err_vs_f64": f64_err,
               "param_grad_rel_err": param_err,
               "param_grad_rel_err_vs_f64": f64_param_err,
               "tolerance": ("dx 1 ulp of bf16" if bf16 else "dx 1e-5")
               + ", dscale and dbias 1e-4 of the largest entry",
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        row.update(bound(3 * n * d * itemsize + 12 * d, 16.0 * n * d,
                         "float32"))
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
    with torch.no_grad():
        odd = ulps(ln.layer_norm(x, scale, bias, LN_EPS),
                   ln.layer_norm_plain(x, scale, bias, LN_EPS)).max().item()
    check(odd <= 1.0, f"layer_norm_fwd 37x100 bf16: {odd} ulps")
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
            reps = dict(reps=3, groups=3, warmup=1)
            ms, plain_ms = in_turns(
                lambda: dr.hw_dropout(x, seed, RATE),
                lambda: dr.hw_dropout_plain(x, seed, RATE), **reps)
            library_ms = cuda_ms(lambda: F.dropout(x, RATE, True))
        n = x.numel()
        row = {"kernel": "hw_dropout", "shape": list(shape),
               "dtype": dtype_name(dtype), "max_abs_err": max_err,
               "kept_set_identical": same_set, "drop_share": share,
               "tolerance": "0 (exact)", "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms}
        # Philox: about 90 integer operations per four elements.
        row.update(bound(2 * n * (2 if dtype == torch.bfloat16 else 4),
                         23.0 * n, "float32"))
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
            marks = (fa.mhsa_short.launches, fa.mhsa_short_backward.launches)
            torch.cuda.synchronize()
            start = time.monotonic()
            state, loss, metrics = train_step(state, batch, 0)
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - start) * 1e3)
            losses.append(loss.item())
            fwd = fa.mhsa_short.launches - marks[0]
            bwd = fa.mhsa_short_backward.launches - marks[1]
            check(fwd == 12 and bwd == 12,
                  f"train step {step}: {fwd} forward and {bwd} backward "
                  "launches of mhsa_short, expected 12 and 12")
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
          f"per step 12 forward + 12 backward; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; total "
          f"predictions {metrics['total_predictions'].item():.0f}",
          flush=True)
    check(eval_after < eval_before,
          f"the eval loss did not fall: {eval_before} -> {eval_after}")


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


def phase_train_c(counters, card):
    """Phase 8: the training entry point end to end, and phase 9, serving
    from its checkpoint. Returns the launches of the path per kernel."""
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

    root = tempfile.mkdtemp(prefix="videocad_train_c_")
    try:
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


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


def kernel_entry(name, replaces, launches, rows, pick, extra):
    """One entry of the kernels line: the times at the train step's shape,
    the largest error over all checks."""
    row = next(r for r in rows if r["kernel"] == name and pick(r))
    source = ("mhsa_short.cu" if name.startswith("mhsa")
              else "layernorm.cu" if name.startswith("layer_norm")
              else "dropout.cu" if name == "hw_dropout"
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
    from videocad_tpu_torch.ops import dropout as dr
    from videocad_tpu_torch.ops import fused_attention as fa
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
    for module in (fa, pp, ln, dr):
        module.load_library()
    print(f"build: {names} in {time.monotonic() - start:.1f} s", flush=True)
    for name in names:
        seconds, log = build.build_log.get(name, (0.0, "(cached)"))
        print(f"build: {name}.cu nvcc {seconds:.1f} s\n{log.strip()}",
              flush=True)

    rows = phase_forward(fa) + phase_forward_dropout(fa, prng)
    rows += phase_backward(fa, prng)
    phase_mask(fa)
    rows += phase_gray(pp)
    rows += phase_layer_norm(ln)
    rows += phase_hw_dropout(dr)
    torch.cuda.empty_cache()

    # name -> (the function that carries the count, the count's attribute);
    # counter(name)() reads a count, counter(name)(0) sets it.
    counted = {
        "mhsa_short": (fa.mhsa_short, "launches"),
        "mhsa_short_bwd": (fa.mhsa_short_backward, "launches"),
        "gray_normalize": (pp.grayscale_normalize_fused, "launches"),
        "gray_resize_normalize": (pp.grayscale_normalize_fused,
                                  "resize_launches"),
        "layer_norm_fwd": (ln.layer_norm, "launches"),
        "layer_norm_bwd": (ln.layer_norm_backward, "launches"),
        "hw_dropout": (dr.hw_dropout, "launches"),
    }

    def counter(name):
        holder, attr = counted[name]
        return lambda *value: (setattr(holder, attr, value[0]) if value
                               else getattr(holder, attr))

    counters = {name: counter(name) for name in counted}
    for reset in counters.values():
        reset(0)                          # the first main path starts here
    engine = phase_serve(fa, np)
    phase_rollout(fa, engine)
    del engine
    torch.cuda.empty_cache()
    phase_train_a(fa)
    torch.cuda.empty_cache()
    phase_train_b(pp)
    launches = {name: read() for name, read in counters.items()}
    torch.cuda.empty_cache()             # the first main path ends here
    launches_c = phase_train_c(counters, card)
    torch.cuda.empty_cache()
    for name in counters:
        check(launches[name] > 0 or launches_c[name] > 0,
              f"neither main path launched a {name} kernel")
    print(f"main path launches: serve, rollout, train A and B {launches}; "
          f"train C {launches_c}", flush=True)
    # The path each kernel is claimed on: train C for the kernels behind
    # ln_impl and dropout_impl, the first path for the others.
    by_path = {name: {"serve_rollout_train_ab": launches[name],
                      "train_c": launches_c[name]} for name in counters}
    launches = {name: launches_c[name] if name.startswith(("layer_norm",
                                                           "hw_dropout"))
                else launches[name] for name in counters}

    phase_reference()
    phase_reference_train()
    phase_reference_train(ln_impl="pallas", dropout_impl="pallas")

    at_train = lambda r: (r["batch"] == TRAIN_FRAMES  # noqa: E731
                          and r["dtype"] == "bfloat16")
    pick_train = lambda r: at_train(r) and r["rate"] == RATE  # noqa: E731
    fwd = kernel_entry(
        "mhsa_short", "videocad_tpu/ops/fused_attention.py:110",
        launches["mhsa_short"], rows, pick_train, attention_bound(4, 4))
    # The times above are with dropout 0.1, as the train step runs it; the
    # same three without dropout, as serving and the rollout run it.
    with_dropout, without = (next(
        r for r in rows if r["kernel"] == "mhsa_short" and at_train(r)
        and r["rate"] == rate) for rate in (RATE, 0.0))
    fwd.update(library_ms=with_dropout["library_ms"], ms_rate0=without["ms"],
               plain_ms_rate0=without["plain_ms"],
               library_ms_rate0=without["library_ms"])
    bwd = kernel_entry(
        "mhsa_short_bwd", "videocad_tpu/ops/fused_attention.py:129",
        launches["mhsa_short_bwd"], rows,
        pick_train, attention_bound(7, 10))
    same = lambda r: {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}  # noqa: E731
    gray = kernel_entry(
        "gray_normalize", "videocad_tpu/ops/preprocess.py:153",
        launches["gray_normalize"], rows, lambda r: True, same)
    resize = kernel_entry(
        "gray_resize_normalize", "videocad_tpu/ops/preprocess.py:167",
        launches["gray_resize_normalize"], rows, lambda r: True, same)
    ln_shape = lambda r: (r["rows"], r["d"]) == LN_SHAPES[0] and (  # noqa: E731
        r["dtype"] == "bfloat16")
    ln_fwd = kernel_entry(
        "layer_norm_fwd", "videocad_tpu/ops/layernorm.py:43",
        launches["layer_norm_fwd"], rows, ln_shape, same)
    ln_bwd = kernel_entry(
        "layer_norm_bwd", "videocad_tpu/ops/layernorm.py:51",
        launches["layer_norm_bwd"], rows, ln_shape, same)
    drop = kernel_entry(
        "hw_dropout", "videocad_tpu/ops/dropout.py:32",
        launches["hw_dropout"], rows,
        lambda r: tuple(r["shape"]) == DROPOUT_SHAPES[0]
        and r["dtype"] == "bfloat16", same)
    kernels = [fwd, bwd, gray, resize, ln_fwd, ln_bwd, drop]
    for entry in kernels:
        entry["launches_by_path"] = by_path[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
