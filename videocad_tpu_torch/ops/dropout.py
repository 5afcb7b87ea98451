"""Elementwise dropout with integer-threshold masks.

Port of the elementwise sites of ``videocad_tpu/ops/dropout.py`` (its
``dropout`` entry point). Raw random bits are compared against an integer
threshold, with the two rate rules of the JAX package:

  * the u8 rule: ``threshold = round(rate * 256)``, so the drop rate
    quantizes to 1/256 (rate 0.1 realizes as 26/256); the keep scale uses
    that EFFECTIVE rate, so E[dropout(x)] == x exactly;
  * rates off the u8 grid (threshold 0 or 256) take an exact u32 threshold
    instead of quantizing to a multiple of the asked rate.

Bits come from an explicit ``torch.Generator`` on the tensor's device; the
numbers differ from JAX's for the same seed, the distributions do not. The
standalone dropout kernel of the JAX package (``impl="pallas"``) is not
ported yet (ROADMAP kernel K5).
"""

from __future__ import annotations

import torch

from videocad_tpu_torch.ops.prng import dropout_threshold


class DropoutRng:
    """The generators a training-mode forward draws from, made from one
    seed: ``seeds`` (on the CPU) yields the int32 seeds of the kernels'
    in-kernel dropout without touching the device, and ``bits`` (on the
    model's device) yields the elementwise sites' masks."""

    def __init__(self, seed: int, device="cpu"):
        self.seeds = torch.Generator().manual_seed(seed)
        self.bits = torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, generator: torch.Generator, rate: float,
            impl: str = "xla") -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest so
    the expectation is unchanged; differentiable (the mask is a constant).
    Rate 0 returns ``x`` itself.
    """
    if rate == 0.0:
        return x
    if impl == "pallas":
        raise NotImplementedError(
            "dropout_impl='pallas' needs the standalone dropout kernel, not "
            "ported yet (ROADMAP kernel K5); use 'xla'")
    if generator is None:
        raise ValueError(f"dropout with rate {rate} needs a torch.Generator")
    threshold = round(rate * 256)
    if not 1 <= threshold <= 255:
        bits = torch.randint(0, 2 ** 32, x.shape, dtype=torch.int64,
                             device=x.device, generator=generator)
        keep = bits >= dropout_threshold(rate)
        eff_rate = rate
    else:
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=generator)
        keep = bits >= threshold
        eff_rate = threshold / 256.0
    return torch.where(keep, x / (1.0 - eff_rate), 0.0)
