"""The LayerNorm backward (K4, ``layer_norm_bwd``) built with other cuts
of its rows, timed on one CUDA card.

    python3 videocad_tpu_torch/cli/ln_bwd_sweep.py [--warps table,4,8]
        [--warp_rows table,1,2,4] [--prefetch table,0,1]
        [--block_rows table,0,64] [--min_blocks table,2,3]

Run it as a file from the root of a checkout. Each option takes a list of
values; every combination is one copy of ``csrc/layernorm.cu`` under
``build/ln_sweep/`` (the source itself is not touched) in which each
vector and exact-width row of the table ``kBwdVariants`` takes the value:
``--warps`` the warps of a block (W), ``--warp_rows`` the rows a warp takes
at a time (R), ``--prefetch`` whether a warp loads its next rows before it
reduces the current (PF), ``--block_rows`` the most rows a block owns (CAP;
0: one wave of blocks). ``--min_blocks`` N gives the row kernel
``__launch_bounds__(W * 32, N)``: the registers capped so that N blocks fit
an SM. ``table`` keeps the source's value; by default the one copy is the
source as it is. The scalar rows and ``kBwdSmall`` stay as they are.

All nvcc processes start together. For each copy one JSON line of the
backward kernels' registers and spills (nvcc -Xptxas -v), then one a shape
of chip_smoke.py's LayerNorm table (76,400 x 512, 74,872 x 1,024 and
400 x 512, bf16 and float32): the partial rows (the blocks), CUDA events
around back-to-back calls, and the device time by torch.profiler (the
largest of three windows), by kernel (the row pass and the sum of its
partials). The last line is the card's name and power limit. A copy whose
text no longer matches the source stops the script.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "ln_sweep"
LN_SHAPES = ((76400, 512), (74872, 1024), (400, 512))
EPS = 1e-5

OPTIONS = ("warps", "warp_rows", "prefetch", "block_rows", "min_blocks")
# A row of kBwdVariants: BWD(dtype, VEC, NV, R, exact, W, PF, CAP)
ROW = re.compile(r"BWD\((\w+), (\d+), (\d+), (\d+), (\w+), (\d+), (\w+), "
                 r"(\d+)\)")
BOUNDS = ("__launch_bounds__(W * 32)\nlayer_norm_bwd_kernel(")
KERNEL = re.compile(r"layer_norm_\w+?_kernel")


def variant_source(source: str, values: dict) -> str:
    """csrc/layernorm.cu with the table's vector and exact-width rows (and
    the row kernel's launch bounds) set to ``values``."""
    head, sep, rest = source.partition("constexpr BwdKernel kBwdVariants[]")
    table, end, tail = rest.partition("};")
    if not sep or not end or len(ROW.findall(table)) != 8:
        sys.exit("ln_bwd_sweep: no table kBwdVariants of 8 rows in "
                 "csrc/layernorm.cu")

    def row(m):
        f = list(m.groups())
        if f[1] != "1":             # the scalar rows stay
            for key, at in (("warp_rows", 3), ("warps", 5),
                            ("prefetch", 6), ("block_rows", 7)):
                if values[key] != "table":
                    f[at] = (("true" if values[key] else "false")
                             if key == "prefetch" else str(values[key]))
        return "BWD(" + ", ".join(f) + ")"

    source = head + sep + ROW.sub(row, table) + end + tail
    if values["min_blocks"] != "table":
        if source.count(BOUNDS) != 1:
            sys.exit(f"ln_bwd_sweep: no {BOUNDS!r} in csrc/layernorm.cu")
        source = source.replace(BOUNDS, BOUNDS.replace(
            "W * 32)", f"W * 32, {values['min_blocks']})"))
    return source


def build_all(builds):
    """[(the copy's values, its library, the backward kernels' ptxas
    lines)], one nvcc each, all started together."""
    from videocad_tpu_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC_DIR / "layernorm.cu").read_text()
    procs = []
    for values in builds:
        tag = "_".join(f"{k}{v}" for k, v in values.items())
        src, lib = OUT / f"layernorm_{tag}.cu", OUT / f"liblayernorm_{tag}.so"
        src.write_text(variant_source(source, values))
        procs.append((values, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for values, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {values}:\n{log}")
        built.append((values, lib, ptxas(log)))
    return built


def ptxas(log):
    """{backward kernel instantiation: [registers, spill store bytes, spill
    load bytes]} from nvcc's -Xptxas -v output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "layer_norm_bwd" in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            # the template arguments: <dtype, VEC, NV, R, exact, W, PF>
            args = re.search(r"kernelI(.*)EEEv", name).group(1)
            usage[args] = [int(m.group(1))] + spills
            name = None
    return usage


def bind(lib):
    """The library's C entries as ops/layernorm.py binds them."""
    from videocad_tpu_torch.ops import layernorm as ln

    entries = []
    for name, (restype, argtypes) in ln._signatures().items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
        entries.append(fn)
    return tuple(entries)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for key in OPTIONS:
        parser.add_argument("--" + key, default="table")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("ln_bwd_sweep: needs a CUDA card")
    from videocad_tpu_torch.cli.profile import profile_work
    from videocad_tpu_torch.cli.wrapper_cost import card, event_ms
    from videocad_tpu_torch.ops import layernorm as ln

    lists = [[v if v == "table" else int(v)
              for v in getattr(args, key).split(",")] for key in OPTIONS]
    builds = [dict(zip(OPTIONS, combo)) for combo in itertools.product(*lists)]
    built = build_all(builds)
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = {}
    for (n, d), dtype in [(s, t) for s in LN_SHAPES
                          for t in (torch.bfloat16, torch.float32)]:
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        g = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        inputs[n, d, dtype] = (x, torch.randn(d, generator=gen,
                                              device="cuda"), g)
    for values, lib, usage in built:
        print(json.dumps({"build": values, "ptxas": usage}), flush=True)
        ln._entries = bind(ctypes.CDLL(str(lib)))
        ln._bwd_blocks.cache_clear()      # the plan is the copy's
        for (n, d, dtype), (x, scale, g) in inputs.items():
            def call():
                return ln.layer_norm_backward(x, scale, g, EPS)
            reports = [profile_work("", call, 10) for _ in range(3)]
            best = max(reports, key=lambda r: r["device_ms"])
            by_kernel = {}
            for ms, _, _, name in best["top"]:
                found = KERNEL.search(name)
                key = found.group(0) if found else name
                by_kernel[key] = by_kernel.get(key, 0.0) + ms
            code = ln._variant_code(d, ln._DTYPE_CODES[dtype], True)
            print(json.dumps({
                "build": values, "shape": [n, d], "dtype": str(dtype)[6:],
                "blocks": ln._bwd_blocks(n, d, code, x.device.index),
                "ms": event_ms(call), "device_ms": best["device_ms"],
                "kernels_device_ms": by_kernel}), flush=True)
    print(card(), flush=True)


if __name__ == "__main__":
    main()
