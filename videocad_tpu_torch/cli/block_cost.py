"""What a call of the fused sub-blocks (K6a, ``attn_block`` forward; K6b,
``attn_block_backward``; K6c, ``mlp_block`` forward; K6d,
``mlp_block_backward``) costs on one CUDA card, piece by piece.

    python3 videocad_tpu_torch/cli/block_cost.py [--root DIR]
        [--batches 1528,8,1]

``--root`` is the checkout whose ``videocad_tpu_torch`` is measured (by
default the one this file is in), so that two versions can be measured on
one card in one session: run the script once per checkout, in turns. Run
it as a file, not with ``-m``: the package is imported from ``--root``.

At the flagship ViT's widths (T = 50, D = 512, 16 heads of 64, an MLP of
512), bf16, each batch of ``--batches`` and dropout 0.1 and 0, one JSON
line per call and kernel variant: the call's time on the host clock (CUDA
events around back-to-back calls) and on the device (torch.profiler, the
kernels' own time, the largest of three windows), and the device time by
kernel (``top``: [ms per call,
launches per call, ms per launch, name]). ``pieces`` groups it: the
sub-block kernel, the weight-gradient products (``grad_weight``: dWo; dW1
and dW2), their split sums (``sum_partials``), the partial rows' sums
(``sum_rows``) and the rest (``torch.matmul``'s GEMM for dWq, dWk, dWv,
the casts of the weights and of the gradients). Where the checkout's
wrapper has more than one kernel variant of a sub-block
(``ops/fused_block.py:ATTN_VARIANTS``, ``MLP_VARIANTS``), every variant
runs on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEQ, DIM, HEADS, HEAD_DIM, MLP = 50, 512, 16, 64, 512


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def event_ms(fn, reps: int, groups: int = 3) -> float:
    """Median over ``groups`` of the mean time of ``reps`` calls, CUDA
    events around them."""
    import torch

    for _ in range(2):
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


def pieces_of(top) -> dict:
    """profile_work's ``top`` rows of one sub-block call grouped by piece:
    the sub-block kernel, the weight-gradient products, their split sums,
    the partial rows' sums and the rest (``other``: torch.matmul's GEMM,
    the casts)."""
    pieces: dict = {}
    for ms, _, _, name in top:
        piece = next((piece for key, piece in (
            ("attn_bwd", "kernel"), ("attn_fwd", "kernel"),
            ("mlp_bwd", "kernel"), ("mlp_fwd", "kernel"),
            ("grad_weight", "weight_products"),
            ("sum_partials", "sum_partials"),
            ("sum_rows", "sum_rows")) if key in name), "other")
        pieces[piece] = pieces.get(piece, 0.0) + ms
    return pieces


def params(gen):
    """One ViT block's attention and MLP parameters, each weight the (in,
    out) view of a matrix stored (out, in), as the model hands them over."""
    import torch

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    lin = lambda i, o: (randn(o, i) * i ** -0.5).t()  # noqa: E731
    vec = lambda n: randn(n) * 0.3  # noqa: E731
    inner = HEADS * HEAD_DIM
    attn = (lin(DIM, inner), lin(DIM, inner), lin(DIM, inner),
            lin(inner, DIM), vec(DIM), 1 + randn(DIM) * 0.09, vec(DIM))
    mlp = (lin(DIM, MLP), vec(MLP), lin(MLP, DIM), vec(DIM),
           1 + randn(DIM) * 0.09, vec(DIM))
    return attn, mlp


def calls_of(fb, x, gy, attn, mlp, seed, rate):
    """(name, variant, function) of every call to measure: each sub-block's
    forward and backward under each variant the checkout has (None where
    it has one)."""
    calls = []
    for variant in getattr(fb, "ATTN_VARIANTS", (None,)):
        if variant is None:
            fwd = lambda: fb.attn_block(x, *attn, seed, HEADS, rate)  # noqa: E731
            bwd = lambda: fb.attn_block_backward(  # noqa: E731
                x, *attn, gy, seed, HEADS, rate)
        else:
            fwd = lambda v=variant: fb._attn_forward(  # noqa: E731
                x, *attn, seed, HEADS, rate, 1e-5, variant=v)
            bwd = lambda v=variant: fb._attn_backward(  # noqa: E731
                x, *attn, gy, seed, HEADS, rate, 1e-5, variant=v)
        calls += [("attn_block_fwd", variant, fwd),
                  ("attn_block_bwd", variant, bwd)]
    for variant in getattr(fb, "MLP_VARIANTS", (None,)):
        if variant is None:
            fwd = lambda: fb.mlp_block(x, *mlp, seed, rate)  # noqa: E731
            bwd = lambda: fb.mlp_block_backward(  # noqa: E731
                x, *mlp, gy, seed, rate)
        else:
            fwd = lambda v=variant: fb._mlp_forward(  # noqa: E731
                x, *mlp, seed, rate, 1e-5, variant=v)
            bwd = lambda v=variant: fb._mlp_backward(  # noqa: E731
                x, *mlp, gy, seed, rate, 1e-5, variant=v)
        calls += [("mlp_block_fwd", variant, fwd),
                  ("mlp_block_bwd", variant, bwd)]
    return calls


def measure(fb, profile_work, batches):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    attn, mlp = params(gen)
    rows = []
    for batch in batches:
        x, gy = (torch.randn((batch, SEQ, DIM), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        for rate in (0.1, 0.0):
            seed = 900 + batch if rate else None
            reps = 3 if batch > 64 else 30
            for name, variant, fn in calls_of(fb, x, gy, attn, mlp, seed,
                                              rate):
                with torch.no_grad():
                    # The tracer may drop kernels of a window, never adds
                    # one: the largest of three windows.
                    report = max((profile_work(name, fn, 5 if batch > 64
                                               else 20, top_n=16)
                                  for _ in range(3)),
                                 key=lambda r: r["device_ms"])
                    ms = event_ms(fn, reps)
                row = {"kernel": name, "variant": variant,
                       "batch": batch, "rate": rate, "ms": ms,
                       "device_ms": report["device_ms"],
                       "kernels": report["kernels"],
                       "pieces": pieces_of(report["top"]),
                       "top": report["top"]}
                print(json.dumps(row), flush=True)
                rows.append(row)
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE.parents[1]))
    parser.add_argument("--batches", default="1528,8,1")
    args = parser.parse_args(argv)
    # The package comes from --root, not from beside this file.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("block_cost: needs a CUDA card")
    from videocad_tpu_torch.cli.profile import profile_work
    from videocad_tpu_torch.ops import fused_block as fb

    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card(),
                      "torch": torch.__version__}), flush=True)
    fb.load_library()
    measure(fb, profile_work, [int(b) for b in args.batches.split(",")])


if __name__ == "__main__":
    main()
