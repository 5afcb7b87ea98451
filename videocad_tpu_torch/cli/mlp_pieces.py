"""Where the time of the MLP sub-block's tensor-core kernels (K6c,
``mlp_fwd_tc_kernel``; K6d, ``mlp_bwd_tc_kernel``) goes, piece by piece,
on one CUDA card.

    python3 videocad_tpu_torch/cli/mlp_pieces.py [--batches 1528,8]

Run it as a file from the root of a checkout. It writes copies of
``csrc/fused_block.cu`` under ``build/pieces/``, each with one piece of
both kernels switched off (the source itself is not touched), builds each
copy with nvcc (all at once), and times both kernels of every copy at the
flagship ViT's widths (T = 50, D = F = 512), bf16, dropout 0.1, the device
time of the kernel alone (torch.profiler, the largest of three windows).
The copies compute wrong values: they only show what each piece costs.

    without_ln        the LayerNorm, do's masking and the LayerNorm
                      backward (the row phases)
    without_epilogue  the epilogues on the accumulators (bias, GELU and
                      its derivative, dropout, the stores)
    without_products  the products (wgmma, mma.sync)
    without_loads     the cp.async loads of the rings
    without_stores    the epilogues' stores (their values are kept alive)
    without_gelu      GELU and its derivative (the identity instead)

A copy whose substitution no longer matches the source stops the script
with the text it looked for: update the table below with the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "pieces"

# piece -> [(text of csrc/fused_block.cu, its replacement)]
PIECES = {
    "without_ln": [
        ("    mlp_ln_rows(x + r0 * d, hs, nullptr, g, be, valid, d, eps);",
         ""),
        ("      mlp_masked_rows(gy + r0 * d, dobbuf + r0 * d, r0, valid, seq,"
         " d, drop,\n                      sum);", ""),
        ("    mlp_ln_rows(x + r0 * d, hs, hbuf + r0 * d, g, be, valid, d, "
         "eps);", ""),
        ("    for (int i = warp; i < valid; i += kWarps) {\n"
         "      float sc[kPerLane]",
         "    for (int i = warp; i < 0; i += kWarps) {\n"
         "      float sc[kPerLane]"),
    ],
    "without_epilogue": [
        ("          if (n0 < f)\n            hidden_epilogue(",
         "          if (false)\n            hidden_epilogue("),
        ("          if (n0 < d)\n            mlp_output_epilogue(",
         "          if (false)\n            mlp_output_epilogue("),
        ("          dz_epilogue(z, dad,", "          if (false) dz_epilogue("
         "z, dad,"),
    ],
    "without_products": [
        ("          if (n0 < f)   // uniform in a warpgroup\n"
         "            wgmma_chunk(",
         "          if (false)\n            wgmma_chunk("),
        ("          if (n0 < d)\n            wgmma_chunk(",
         "          if (false)\n            wgmma_chunk("),
        ("          mma_swz<2, 2, false>(", "          if (false) "
         "mma_swz<2, 2, false>("),
        ("          mma_swz<2, 2, true>(", "          if (false) "
         "mma_swz<2, 2, true>("),
        ("          if (n0 < d)\n            mma_swz<2, 4, true>(",
         "          if (false)\n            mma_swz<2, 4, true>("),
    ],
    "without_loads": [
        ("      const int p = c / kd * kMlpPass;\n      stage_swizzled(",
         "      const int p = c / kd * kMlpPass;\n      if (false) "
         "stage_swizzled("),
        ("          stage_swizzled(st, a0 + k0, f, 64, 64);\n"
         "          stage_swizzled(",
         "          return;\n          stage_swizzled("),
        ("          const int fc = c / kd * 64, k0 = (c % kd) * 64;\n",
         "          return;\n          const int fc = c / kd * 64, "
         "k0 = (c % kd) * 64;\n"),
        ("          const int n0 = c / kf * 128, k0 = (c % kf) * 64;\n",
         "          return;\n          const int n0 = c / kf * 128, "
         "k0 = (c % kf) * 64;\n"),
    ],
    "without_stores": [
        ("      *reinterpret_cast<uint32_t*>(a0 + (wr + gr + 8 * h) * f + "
         "col) =",
         "      if (a_0 == 12345.f)\n      *reinterpret_cast<uint32_t*>(a0 "
         "+ (wr + gr + 8 * h) * f + col) ="),
        ("      *reinterpret_cast<uint32_t*>(y + r * d + col) = pack_bf16(",
         "      if (o0 == 12345.f)\n      *reinterpret_cast<uint32_t*>(y + "
         "r * d + col) = pack_bf16("),
        ("        *reinterpret_cast<uint32_t*>(abbuf + at) =",
         "        if (a[0] == 12345.f)\n        *reinterpret_cast<uint32_t*>"
         "(abbuf + at) ="),
        ("        *reinterpret_cast<uint32_t*>(dzbuf + at) =",
         "        if (dz[0] == 12345.f)\n        *reinterpret_cast<uint32_t*>"
         "(dzbuf + at) ="),
    ],
    "without_gelu": [
        ("      float a_0 = gelu(z[at] + bias0), a_1 = gelu(z[at + 1] + "
         "bias1);",
         "      float a_0 = z[at] + bias0, a_1 = z[at + 1] + bias1;"),
        ("          a[e] = gelu(zz);", "          a[e] = zz;"),
        ("          dz[e] = da * dgelu(zz);", "          dz[e] = da;"),
    ],
}


def variant_source(source: str, piece: str) -> str:
    for old, new in PIECES[piece]:
        if source.count(old) != 1:
            sys.exit(f"mlp_pieces: {piece}: {source.count(old)} matches of "
                     f"{old!r} in csrc/fused_block.cu")
        source = source.replace(old, new)
    return source


def build(names) -> dict:
    """name -> the loaded library of csrc/fused_block.cu (name "all") or of
    its copy without a piece, every nvcc at once."""
    from videocad_tpu_torch.kernels import build as kb

    OUT.mkdir(parents=True, exist_ok=True)
    source = (kb.CSRC_DIR / "fused_block.cu").read_text()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(source if name == "all"
                       else variant_source(source, name))
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC_DIR), "-o",
             str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"mlp_pieces: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1528,8")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("mlp_pieces: needs a CUDA card")
    from videocad_tpu_torch.cli.block_cost import card, params
    from videocad_tpu_torch.cli.profile import profile_work
    from videocad_tpu_torch.ops import fused_block as fb

    print(json.dumps({"card": card(), "torch": torch.__version__}),
          flush=True)
    libs = build(["all"] + list(PIECES))
    gen = torch.Generator(device="cuda").manual_seed(3)
    _, mlp = params(gen)

    def kernel_ms(fn, kernel):
        # The tracer may drop kernels of a window: the largest of three.
        return max(sum(r[0] for r in profile_work("", fn, 5, top_n=8)["top"]
                       if kernel in r[3]) for _ in range(3))

    for batch in (int(b) for b in args.batches.split(",")):
        x, gy = (torch.randn((batch, 50, 512), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        for name, lib in libs.items():
            entries = {}
            for entry, (restype, argtypes) in fb._signatures().items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, argtypes
                entries[entry] = fn
            fb._entries = entries
            with torch.no_grad():
                fwd = kernel_ms(lambda: fb._mlp_forward(
                    x, *mlp, 5, 0.1, 1e-5, variant="tc"), "mlp_fwd_tc")
                bwd = kernel_ms(lambda: fb._mlp_backward(
                    x, *mlp, gy, 5, 0.1, 1e-5, variant="tc"), "mlp_bwd_tc")
            print(json.dumps({"pieces": name, "batch": batch, "rate": 0.1,
                              "mlp_fwd_tc_kernel_ms": fwd,
                              "mlp_bwd_tc_kernel_ms": bwd}), flush=True)


if __name__ == "__main__":
    main()
