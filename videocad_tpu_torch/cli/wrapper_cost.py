"""What a call of the kernel wrappers costs, piece by piece, on one CUDA
card: the short-sequence attention (K1), the grayscale resize (K2b), the
flash attention (K3), the LayerNorm forward and backward (K4) and the
standalone dropout (K5).

    python3 videocad_tpu_torch/cli/wrapper_cost.py [--root DIR]
        [--calls 10000] [--repeats 3] [--part host|kernels|both]
        [--only mhsa_short,gray_resize_normalize,...]

``--root`` is the checkout whose ``videocad_tpu_torch`` is measured (by
default the one this file is in), so two versions of the wrappers and
kernels can be measured on one card in one session: run the script once
per checkout, in turns. Run it as a file, not with ``-m``: the package is
imported from ``--root``.

Two parts, one JSON line per row:

* ``host``: the host's time per call in microseconds (host clock over
  ``--calls`` calls, the median of ``--repeats`` runs) at the shapes the
  paths give each wrapper: K5 at (8, 4, 191, 191) bf16, K4 at 400 x 512
  bf16 (forward and backward), K1 at 8 and 1,528 frames (bf16, dropout
  0.1; forward and backward), K2b at (8, 256, 256, 3) -> 224 x 224, K3 at
  (8, 191, 4, 256) bf16, dropout 0.1, causal and banded to 10. At the small
  shapes the device keeps up, so the wrapper's time is the host's; at
  1,528 frames it is the kernel's. Pieces: the wrapper as a model calls it
  (no grad, and under autograd where it is differentiable), the wrapper
  with its C entry replaced by a Python function that returns 0 (no
  ctypes call, no launch), the C entry alone with the wrapper's own
  arguments (with the launch, and with a size of 0, which returns before
  it), the pieces a wrapper may take on its way (a device guard, a
  ``torch.cuda.Stream`` object, the raw stream, ``empty_like``,
  ``x.device``, K4's and K5's input checks), ``derive_seed`` and the
  library call where one computes the same function (``F.dropout``,
  ``F.layer_norm`` and its backward, ``F.scaled_dot_product_attention``).
* ``kernels``: the kernels at the shapes of chip_smoke.py's tables (K4's
  forward and backward, K5) and at the host part's (K1, K2b, K3), on the
  host clock (CUDA events around back-to-back calls) and on the device
  (torch.profiler, the kernels' own time; the largest of three windows).

``--only`` keeps the rows of the kernels it names (``hw_dropout``,
``layer_norm_fwd``, ``layer_norm_bwd``, ``mhsa_short``, ``mhsa_short_bwd``,
``gray_resize_normalize``, ``flash_attention``,
``flash_attention_backward``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
LN_SHAPES = ((76400, 512), (74872, 1024), (400, 512))
DROPOUT_SHAPES = ((1528, 50, 512), (8, 4, 191, 191), (1000003,))
RATE, EPS = 0.1, 1e-5
HEADS = 16                          # the ViT's: (B, 50, 16 x 64)
FLASH_SHAPE = (8, 191, 4, 256)      # the decoder's self-attention


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def host_us(fn, calls: int, repeats: int) -> float:
    """Median over ``repeats`` of the host's microseconds per call."""
    import torch

    for _ in range(100):
        fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - start) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn, reps: int = 20, groups: int = 5) -> float:
    """Median over ``groups`` of the mean time of ``reps`` calls, CUDA
    events around them."""
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


def entry_at(entries, path):
    """The C entry at ``path`` (keys into the module's dicts and tuples of
    entries)."""
    for key in path:
        entries = entries[key]
    return entries


def replaced(entries, path, fn):
    """``entries`` with the entry at ``path`` replaced by ``fn``."""
    if not path:
        return fn
    key, rest = path[0], path[1:]
    if isinstance(entries, dict):
        return dict(entries, **{key: replaced(entries[key], rest, fn)})
    out = list(entries)
    out[key] = replaced(entries[key], rest, fn)
    return tuple(out)


def recorded_args(module, attr, path, call):
    """The arguments ``call`` passes to the C entry at ``path`` of
    ``module.<attr>`` (its table of entries, or its one entry)."""
    entries = getattr(module, attr)
    seen = []

    def record(*args):
        seen.append(args)
        return 0
    setattr(module, attr, replaced(entries, path, record))
    try:
        call()
    finally:
        setattr(module, attr, entries)
    return seen[0]


def host_cases(modules):
    """One dict a row of the host part: the wrapper call, the C entry it
    reaches (module and path), a size among its arguments, and the
    optional pieces (autograd, checks, library)."""
    import torch
    import torch.nn.functional as F

    dr, ln, fa, pp, fl = (modules[k] for k in ("dr", "ln", "fa", "pp", "fl"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    cases = []
    x = randn(8, 4, 191, 191)
    cases.append(dict(
        kernel="hw_dropout", shape=list(x.shape), x=x,
        call=lambda t: dr.hw_dropout(t, 7, RATE), module=dr, attr="_entry",
        path=(), size=x.numel(), checks=lambda: dr._check_rate(RATE),
        library=lambda: F.dropout(x, RATE, True)))
    x, g = randn(400, 512), randn(400, 512)
    scale = torch.ones(512, device="cuda")
    bias = torch.zeros(512, device="cuda")
    lib_w, lib_b = scale.bfloat16(), bias.bfloat16()
    cases.append(dict(
        kernel="layer_norm_fwd", shape=list(x.shape), x=x,
        call=lambda t: ln.layer_norm(t, scale, bias, EPS), module=ln,
        path=(0,), size=400,
        checks=lambda: (ln._check(x, scale, bias),
                        ln._check_kernel_inputs(x, scale, bias)),
        library=lambda: F.layer_norm(x, (512,), lib_w, lib_b, EPS)))
    leaves = [t.clone().requires_grad_() for t in (x, lib_w, lib_b)]
    lib_out = F.layer_norm(leaves[0], (512,), leaves[1], leaves[2], EPS)
    cases.append(dict(
        kernel="layer_norm_bwd", shape=list(x.shape), x=x,
        call=lambda t: ln.layer_norm_backward(t, scale, g, EPS), module=ln,
        path=(1,), size=400, grad=False,
        checks=lambda: ln._check_kernel_inputs(x, scale),
        library=lambda: torch.autograd.grad(lib_out, leaves, g,
                                            retain_graph=True)))
    for batch in (8, 1528):
        q, k, v, gq = (randn(batch, 50, 1024) for _ in range(4))
        cases.append(dict(
            kernel="mhsa_short", shape=list(q.shape), x=q,
            call=lambda t, k=k, v=v: fa.mhsa_short(t, k, v, 11, HEADS,
                                                   RATE),
            module=fa, path=("tc", 0), size=batch, share=8 / batch,
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                *(t.view(t.shape[0], 50, HEADS, 64).transpose(1, 2)
                  for t in (q, k, v)), dropout_p=RATE)))
        cases.append(dict(
            kernel="mhsa_short_bwd", shape=list(q.shape), x=q,
            call=lambda t, k=k, v=v, gq=gq: fa.mhsa_short_backward(
                t, k, v, gq, 11, HEADS, RATE),
            module=fa, path=("tc", 1), size=batch, grad=False,
            share=8 / batch))
    images = torch.randint(0, 256, (8, 256, 256, 3), generator=gen,
                           dtype=torch.uint8, device="cuda")
    cases.append(dict(
        kernel="gray_resize_normalize", shape=list(images.shape), x=images,
        call=lambda t: pp.grayscale_normalize_fused(t, True, (224, 224)),
        module=pp, path=(1,), size=8, grad=False))
    q, k, v = (randn(*FLASH_SHAPE) for _ in range(3))
    t_len = FLASH_SHAPE[1]
    for kind, mask in (("causal", fl.BandMask(t_len, t_len)),
                       ("band10", fl.BandMask(t_len, t_len, 10))):
        bool_mask = mask.tensor("cuda")
        cases.append(dict(
            kernel="flash_attention", mask=kind, shape=list(q.shape), x=q,
            call=lambda t, mask=mask: fl.flash_attention(t, k, v, mask, 5,
                                                         RATE),
            module=fl, path=("tc", 0), size=FLASH_SHAPE[0],
            library=lambda bool_mask=bool_mask:
                F.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in (q, k, v)),
                    attn_mask=bool_mask, dropout_p=RATE)))
    return cases


def host_part(modules, prng, full_calls, repeats, keep):
    import torch

    rows = []
    for case in host_cases(modules):
        if not keep(case["kernel"]):
            continue
        # At 1,528 frames a call is the kernel's time: fewer calls do.
        calls = max(100, int(full_calls * case.get("share", 1.0)))
        module, path, x = case["module"], case["path"], case["x"]
        attr = case.get("attr", "_entries")
        call = case["call"]
        entry = entry_at(getattr(module, attr), path)
        args = recorded_args(module, attr, path, lambda: call(x))
        # The first argument equal to the case's size (rows, elements or
        # batch, which no pointer equals) set to 0: the entry refuses it.
        at = next(i for i, a in enumerate(args)
                  if isinstance(a, int) and a == case["size"])
        args0 = args[:at] + (0,) + args[at + 1:]
        pieces = {}
        with torch.no_grad():
            pieces["wrapper"] = host_us(lambda: call(x), calls, repeats)
            saved = getattr(module, attr)
            setattr(module, attr, replaced(saved, path, lambda *a: 0))
            try:
                pieces["wrapper_without_ctypes_call"] = host_us(
                    lambda: call(x), calls, repeats)
            finally:
                setattr(module, attr, saved)
            pieces["ctypes_call_with_launch"] = host_us(
                lambda: entry(*args), calls, repeats)
            pieces["ctypes_call_without_launch"] = host_us(
                lambda: entry(*args0), calls, repeats)

            def guard():
                with torch.cuda.device(x.device):
                    pass
            pieces["device_guard"] = host_us(guard, calls, repeats)
            pieces["stream_object"] = host_us(
                lambda: torch.cuda.current_stream(x.device).cuda_stream,
                calls, repeats)
            pieces["raw_stream"] = host_us(
                lambda: torch._C._cuda_getCurrentRawStream(0), calls,
                repeats)
            pieces["empty_like"] = host_us(lambda: torch.empty_like(x),
                                           calls, repeats)
            pieces["x_device"] = host_us(lambda: x.device, calls, repeats)
            if case.get("checks"):
                pieces["checks"] = host_us(case["checks"], calls, repeats)
            if case.get("library"):
                pieces["library"] = host_us(case["library"], calls, repeats)
        if case.get("grad", True) and x.is_floating_point():
            leaf = x.clone().requires_grad_()
            pieces["wrapper_autograd"] = host_us(lambda: call(leaf), calls,
                                                 repeats)
        if case["kernel"] == "hw_dropout":
            seeds = torch.Generator().manual_seed(0)
            pieces["derive_seed"] = host_us(lambda: prng.derive_seed(seeds),
                                            calls, repeats)
        row = {"part": "host", "kernel": case["kernel"],
               "shape": case["shape"], "calls": calls, "repeats": repeats,
               "us": pieces}
        if "mask" in case:
            row["mask"] = case["mask"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def device_ms(profile_work, fn) -> float:
    """The kernels' own time of a call: the largest of three profiler
    windows (the tracer may drop kernels of a window, never adds one)."""
    return max(profile_work("", fn, 10)["device_ms"] for _ in range(3))


def kernel_part(modules, profile_work, keep):
    import torch

    dr, ln, fa, pp, fl = (modules[k] for k in ("dr", "ln", "fa", "pp", "fl"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    def report(kernel, shape, dtype, fn, **extra):
        if not keep(kernel):
            return
        with torch.no_grad():
            row = {"part": "kernels", "kernel": kernel, "shape": list(shape),
                   "dtype": str(dtype)[6:], **extra, "ms": event_ms(fn),
                   "device_ms": device_ms(profile_work, fn)}
        print(json.dumps(row), flush=True)
        rows.append(row)

    for (n, d), dtype in [(s, t) for s in LN_SHAPES
                          for t in (torch.bfloat16, torch.float32)]:
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        g = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        scale = torch.randn(d, generator=gen, device="cuda")
        bias = torch.randn(d, generator=gen, device="cuda")
        report("layer_norm_fwd", (n, d), dtype,
               lambda: ln.layer_norm(x, scale, bias, EPS))
        report("layer_norm_bwd", (n, d), dtype,
               lambda: ln.layer_norm_backward(x, scale, g, EPS))
    for shape, dtype in [(s, t) for s in DROPOUT_SHAPES
                         for t in (torch.bfloat16, torch.float32)]:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        report("hw_dropout", shape, dtype, lambda: dr.hw_dropout(x, 9, RATE))
    bf16 = torch.bfloat16
    for batch in (8, 1528):
        q, k, v, g = (torch.randn((batch, 50, 1024), generator=gen,
                                  device="cuda").to(bf16) for _ in range(4))
        report("mhsa_short", q.shape, bf16,
               lambda: fa.mhsa_short(q, k, v, 11, HEADS, RATE))
        report("mhsa_short_bwd", q.shape, bf16,
               lambda: fa.mhsa_short_backward(q, k, v, g, 11, HEADS, RATE))
    images = torch.randint(0, 256, (8, 256, 256, 3), generator=gen,
                           dtype=torch.uint8, device="cuda")
    report("gray_resize_normalize", images.shape, torch.float32,
           lambda: pp.grayscale_normalize_fused(images, True, (224, 224)))
    q, k, v, g = (torch.randn(FLASH_SHAPE, generator=gen,
                              device="cuda").to(bf16) for _ in range(4))
    t_len = FLASH_SHAPE[1]
    for kind, mask in (("causal", fl.BandMask(t_len, t_len)),
                       ("band10", fl.BandMask(t_len, t_len, 10))):
        out, lse = fl.flash_attention_forward(q, k, v, mask, 5, RATE)
        report("flash_attention", q.shape, bf16,
               lambda: fl.flash_attention(q, k, v, mask, 5, RATE), mask=kind)
        report("flash_attention_backward", q.shape, bf16,
               lambda: fl.flash_attention_backward(q, k, v, mask, 5, out,
                                                   lse, g, RATE), mask=kind)
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE.parents[1]))
    parser.add_argument("--calls", type=int, default=10000)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--part", choices=("host", "kernels", "both"),
                        default="both")
    parser.add_argument("--only", default="",
                        help="comma-separated kernel names (default: all)")
    args = parser.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    keep = lambda kernel: not only or kernel in only  # noqa: E731
    # The package comes from --root, not from beside this file.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("wrapper_cost: needs a CUDA card")
    from videocad_tpu_torch.cli.profile import profile_work
    from videocad_tpu_torch.ops import attention as fl
    from videocad_tpu_torch.ops import dropout as dr
    from videocad_tpu_torch.ops import fused_attention as fa
    from videocad_tpu_torch.ops import layernorm as ln
    from videocad_tpu_torch.ops import preprocess as pp
    from videocad_tpu_torch.ops import prng

    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card(),
                      "torch": torch.__version__}), flush=True)
    modules = {"dr": dr, "ln": ln, "fa": fa, "pp": pp, "fl": fl}
    for module in modules.values():
        module.load_library()
    if args.part in ("host", "both"):
        host_part(modules, prng, args.calls, args.repeats, keep)
    if args.part in ("kernels", "both"):
        kernel_part(modules, profile_work, keep)


if __name__ == "__main__":
    main()
