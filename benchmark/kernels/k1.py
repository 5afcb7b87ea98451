"""Kernel K1, the ViT's short-sequence attention (``mhsa_short``): the
device kernels its source names, and the least work a call needs.

A call takes q, k, v of (B, T, H * D) in the I/O dtype. The forward reads
the three once and writes the output once, and needs the two products
(4 B H T^2 D FLOPs); the backward reads q, k, v and the output's gradient
and writes three gradients, and needs four products (8 B H T^2 D; the
recomputed scores are not counted). The bound of a call is the larger of
its bytes over the HBM rate and its FLOPs over the bf16 peak.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from benchmark.flops import H100_BF16_FLOPS, H100_HBM_BYTES_S
from benchmark.reference.model import sizes

NAME = re.compile(r"mhsa_short")


def call_bound_s(batch: int, t: int, heads: int, head_dim: int,
                 backward: bool, itemsize: int = 2) -> float:
    tensor = batch * t * heads * head_dim * itemsize
    nbytes = (7 if backward else 4) * tensor
    flops = (8 if backward else 4) * batch * heads * t * t * head_dim
    return max(nbytes / H100_HBM_BYTES_S, flops / H100_BF16_FLOPS)


def train_step_calls(cfg: Dict, batch: int, t: int
                     ) -> List[Tuple[int, int, bool]]:
    """(frames, tokens, backward) of every K1 call of one train step: each
    ViT block of the state encoder (B * T frames) and of the CAD encoder
    (B images), forward and backward."""
    s = sizes(cfg)
    tokens = (s["image"] // s["patch"]) ** 2 + 1
    cad_tokens = (256 // s["patch"]) ** 2 + 1 if s["gencad"] else tokens
    calls = []
    for frames, n in ((batch * t, tokens), (batch, cad_tokens)):
        for _ in range(s["vit_depth"]):
            calls += [(frames, n, False), (frames, n, True)]
    return calls


def train_step_bound_s(cfg: Dict, batch: int, t: int) -> float:
    s = sizes(cfg)
    return sum(call_bound_s(frames, n, s["vit_heads"], s["vit_head_dim"], bwd)
               for frames, n, bwd in train_step_calls(cfg, batch, t))


def device_seconds(by_name: Dict[str, float]) -> float:
    """The summed device time of the kernels this file names."""
    return sum(sec for name, sec in by_name.items() if NAME.search(name))
