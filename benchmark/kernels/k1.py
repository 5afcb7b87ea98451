"""Kernel K1, the ViT's short-sequence attention (``mhsa_short``): the
device kernels its source names, and the least work a call needs.

A call takes q, k, v of (B, T, H * D) in the I/O dtype. The forward reads
the three once and writes the output once, and needs the two products
(4 B H T^2 D FLOPs); the backward reads q, k, v and the output's gradient
and writes three gradients, and needs four products (8 B H T^2 D; the
recomputed scores are not counted). The bound of a call is the larger of
its bytes over the HBM rate and its FLOPs over the bf16 peak. Which calls
a train step makes is its model family's (``k1_calls``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from benchmark.flops import H100_BF16_FLOPS, H100_HBM_BYTES_S

NAME = re.compile(r"mhsa_short")


def call_bound_s(batch: int, t: int, heads: int, head_dim: int,
                 backward: bool, itemsize: int = 2) -> float:
    tensor = batch * t * heads * head_dim * itemsize
    nbytes = (7 if backward else 4) * tensor
    flops = (8 if backward else 4) * batch * heads * t * t * head_dim
    return max(nbytes / H100_HBM_BYTES_S, flops / H100_BF16_FLOPS)


def calls_bound_s(calls: List[Tuple[int, int, int, int, bool]]) -> float:
    """The summed bound of (frames, tokens, heads, head_dim, backward)
    calls: a family's ``k1_calls`` of a train step."""
    return sum(call_bound_s(*call) for call in calls)


def device_seconds(by_name: Dict[str, float]) -> float:
    """The summed device time of the kernels this file names."""
    return sum(sec for name, sec in by_name.items() if NAME.search(name))
