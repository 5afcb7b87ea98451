"""The randomness the train step's dropout draws from, worked out again.

A frozen copy of the rules the program states for its dropout: a step's
dropout seed is ``fold_in(fold_in(seed, step), 1)``; the attention kernels'
masks are Philox4x32-10 of (seed, 0) at counter (key // 4, query, head,
row); the elementwise sites draw uint8 bits from a ``torch.Generator`` on
the device seeded with the step's dropout seed, and each kernel call draws
its int32 seed from a CPU ``torch.Generator`` with the same seed. The
reference replays the draws in the order the forward makes them, so it
drops what the program drops without reading anything the program made.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1


def fold_in(seed: int, data: int) -> int:
    """splitmix64's finalizer over (seed, data): a 63-bit seed."""
    mask = (1 << 64) - 1
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def _mulhilo(a: int, b: torch.Tensor):
    lo = a * (b & 0xFFFF)
    hi = a * (b >> 16)
    total_lo = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (total_lo >> 32), total_lo & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 over four uint32 words held in int64."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def attention_keep(seed: int, rows: int, heads: int, length: int,
                   rate: float, device, row_offset: int = 0) -> torch.Tensor:
    """(rows, heads, length, length) bool: the attention kernels' keep mask
    (a weight is kept where its 32 bits reach ``rate * 2**32``)."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    groups = (length + 3) // 4
    counter = (ar(groups).view(1, 1, 1, groups),
               ar(length).view(1, 1, length, 1),
               ar(heads).view(1, heads, 1, 1),
               (ar(rows) + row_offset).view(rows, 1, 1, 1))
    words = torch.broadcast_tensors(*philox4x32(counter, (seed, 0)))
    bits = torch.stack(words, dim=-1).reshape(rows, heads, length,
                                              groups * 4)[..., :length]
    return bits >= min(int(rate * 2 ** 32), 2 ** 32 - 1)


class DropoutReplay:
    """The step's two generators, drawn from in the program's order."""

    def __init__(self, seed: int, rate: float, device):
        self.rate = rate
        self.device = device
        self.seeds = torch.Generator().manual_seed(seed)
        self.bits = torch.Generator(device=device).manual_seed(seed)

    def kernel_seed(self) -> int:
        return int(torch.randint(0, _INT32_MAX, (), generator=self.seeds))

    def elementwise(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sites' rule: uint8 bits against round(rate *
        256), the keep scale from that effective rate."""
        threshold = round(self.rate * 256)
        if not 1 <= threshold <= 255:
            bits = torch.randint(0, 2 ** 32, x.shape, dtype=torch.int64,
                                 device=self.device, generator=self.bits)
            keep = bits >= min(int(self.rate * 2 ** 32), 2 ** 32 - 1)
            eff = self.rate
        else:
            bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                                 device=self.device, generator=self.bits)
            keep = bits >= threshold
            eff = threshold / 256.0
        return torch.where(keep, x / (1.0 - eff), 0.0)
