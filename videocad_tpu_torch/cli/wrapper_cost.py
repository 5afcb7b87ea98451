"""What a call of the standalone dropout (K5) and of the LayerNorm forward
(K4) costs, piece by piece, on one CUDA card.

    python3 videocad_tpu_torch/cli/wrapper_cost.py [--root DIR]
        [--calls 10000] [--repeats 3]

``--root`` is the checkout whose ``videocad_tpu_torch`` is measured (by
default the one this file is in), so two versions of the wrappers and
kernels can be measured on one card in one session: run the script once
per checkout, in turns. Run it as a file, not with ``-m``: the package is
imported from ``--root``.

Two parts, one JSON line per row:

* ``host``: the host's time per call in microseconds (host clock over
  ``--calls`` calls, the median of ``--repeats`` runs; the device keeps up
  at these shapes) at K5's (8, 4, 191, 191) bf16 and K4's 400 x 512 bf16:
  the wrapper as a model calls it (no grad, and under autograd), the
  wrapper with its C entry replaced by a Python function that returns 0
  (no ctypes call, no launch), the C entry alone with the wrapper's own
  arguments (with the launch, and with a size of 0, which returns before
  it), the pieces a wrapper may take on its way (a device guard, a
  ``torch.cuda.Stream`` object, the raw stream, ``empty_like``,
  ``x.device``, the wrapper's input checks), ``derive_seed`` and the
  library call (``F.dropout``, ``F.layer_norm``).
* ``kernels``: each kernel at the shapes of chip_smoke.py's tables, on the
  host clock (CUDA events around back-to-back calls) and on the device
  (torch.profiler, the kernels' own time).
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


def recorded_args(module, attr, index, call):
    """The arguments ``call`` passes to the C entry ``module.<attr>``
    (``[index]`` of it where it is a tuple of entries)."""
    entries = getattr(module, attr)
    seen = []

    def record(*args):
        seen.append(args)
        return 0
    stub = (record if index is None else
            tuple(record if i == index else e for i, e in enumerate(entries)))
    setattr(module, attr, stub)
    try:
        call()
    finally:
        setattr(module, attr, entries)
    return seen[0]


def host_part(dr, ln, prng, calls, repeats):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel in ("hw_dropout", "layer_norm_fwd"):
        if kernel == "hw_dropout":
            x = torch.randn((8, 4, 191, 191), generator=gen,
                            device="cuda").to(torch.bfloat16)
            wrapper = lambda t: dr.hw_dropout(t, 7, RATE)  # noqa: E731
            library = lambda: F.dropout(x, RATE, True)  # noqa: E731
            checks = lambda: dr._check_rate(RATE)  # noqa: E731
            module, attr, index, size_at = dr, "_entry", None, 2
        else:
            x = torch.randn((400, 512), generator=gen,
                            device="cuda").to(torch.bfloat16)
            scale = torch.ones(512, device="cuda")
            bias = torch.zeros(512, device="cuda")
            wrapper = lambda t: ln.layer_norm(t, scale, bias, EPS)  # noqa: E731
            lib_w, lib_b = scale.bfloat16(), bias.bfloat16()
            library = lambda: F.layer_norm(  # noqa: E731
                x, (512,), lib_w, lib_b, EPS)
            checks = lambda: (ln._check(x, scale, bias),  # noqa: E731
                              ln._check_kernel_inputs(x, scale, bias))
            module, attr, index, size_at = ln, "_entries", 0, 4
        entries = getattr(module, attr)
        entry = entries if index is None else entries[index]
        args = recorded_args(module, attr, index, lambda: wrapper(x))
        args0 = args[:size_at] + (0,) + args[size_at + 1:]
        leaf = x.clone().requires_grad_()
        stub = (lambda *a: 0) if index is None else tuple(
            (lambda *a: 0) if i == index else e for i, e in enumerate(entries))
        pieces = {}
        with torch.no_grad():
            pieces["wrapper"] = host_us(lambda: wrapper(x), calls, repeats)
            setattr(module, attr, stub)
            try:
                pieces["wrapper_without_ctypes_call"] = host_us(
                    lambda: wrapper(x), calls, repeats)
            finally:
                setattr(module, attr, entries)
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
            pieces["checks"] = host_us(checks, calls, repeats)
            pieces["library"] = host_us(library, calls, repeats)
        pieces["wrapper_autograd"] = host_us(lambda: wrapper(leaf), calls,
                                             repeats)
        if kernel == "hw_dropout":
            seeds = torch.Generator().manual_seed(0)
            pieces["derive_seed"] = host_us(lambda: prng.derive_seed(seeds),
                                            calls, repeats)
        row = {"part": "host", "kernel": kernel, "shape": list(x.shape),
               "calls": calls, "repeats": repeats, "us": pieces}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def kernel_part(dr, ln, profile_work):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for (n, d), dtype in [(s, t) for s in LN_SHAPES
                          for t in (torch.bfloat16, torch.float32)]:
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        scale = torch.randn(d, generator=gen, device="cuda")
        bias = torch.randn(d, generator=gen, device="cuda")
        fn = lambda: ln.layer_norm(x, scale, bias, EPS)  # noqa: E731
        with torch.no_grad():
            row = {"part": "kernels", "kernel": "layer_norm_fwd",
                   "shape": [n, d], "dtype": str(dtype)[6:],
                   "ms": event_ms(fn),
                   "device_ms": profile_work("", fn, 10)["device_ms"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    for shape, dtype in [(s, t) for s in DROPOUT_SHAPES
                         for t in (torch.bfloat16, torch.float32)]:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        fn = lambda: dr.hw_dropout(x, 9, RATE)  # noqa: E731
        with torch.no_grad():
            row = {"part": "kernels", "kernel": "hw_dropout",
                   "shape": list(shape), "dtype": str(dtype)[6:],
                   "ms": event_ms(fn),
                   "device_ms": profile_work("", fn, 10)["device_ms"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE.parents[1]))
    parser.add_argument("--calls", type=int, default=10000)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    # The package comes from --root, not from beside this file.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("wrapper_cost: needs a CUDA card")
    from videocad_tpu_torch.cli.profile import profile_work
    from videocad_tpu_torch.ops import dropout as dr
    from videocad_tpu_torch.ops import layernorm as ln
    from videocad_tpu_torch.ops import prng

    print(json.dumps({"root": str(Path(args.root).resolve()), "card": card(),
                      "torch": torch.__version__}), flush=True)
    dr.load_library()
    ln.load_library()
    host_part(dr, ln, prng, args.calls, args.repeats)
    kernel_part(dr, ln, profile_work)


if __name__ == "__main__":
    main()
