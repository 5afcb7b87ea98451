"""Dropout randomness shared by the kernels, their plain versions and
their callers.

Port of ``videocad_tpu/ops/prng.py``. The uint32-threshold rule must stay
identical wherever a kernel's forward and backward regenerate one mask, so
it has one definition here (and one in each of ``csrc/mhsa_short.cu``,
``csrc/flash_attention.cu``, ``csrc/dropout.cu`` and
``csrc/fused_block.cu``, held equal on the card).

Where the TPU kernels seed a hardware generator per batch row, the Hopper
kernels use a counter-based function: :func:`dropout_bits` maps (seed,
batch row, head, query, key) to 32 bits with Philox4x32-10 and nothing
else enters it, so the mask is the same for every grid and block shape,
and the backward of a call redraws its forward's mask from the seed alone.
The same function is written here in PyTorch integer ops, so a plain
version draws the very mask its kernel draws. :func:`elementwise_bits` is
the standalone dropout kernel's function: (seed, flat element index) to 32
bits. Each kernel family has a key word of its own, so that no two of them
ever share a stream under one seed: the short-sequence attention kernels
``(seed, 0)``, the standalone dropout ``(seed, 1)``, the flash attention
kernels ``(seed, 2)`` (:data:`FLASH_KEY_WORD`), the four dropout sites of
the fused ViT sub-block kernels ``(seed, 3 + site)``
(:data:`BLOCK_KEY_WORD`, :func:`block_site_bits`).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57    # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85    # Philox key increments (Weyl)
_MASK32 = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1
FLASH_KEY_WORD = 2    # the flash attention kernels' second key word
BLOCK_KEY_WORD = 3    # the fused sub-block kernels': 3 + site, sites 0..3
# The fused sub-block kernels' dropout sites (videocad_tpu/ops/fused_block.py
# numbers them the same way).
SITE_ATTN_W = 0       # attention weights, (heads, T, T) a frame
SITE_ATTN_RES = 1     # attention residual branch, (T, D)
SITE_MLP_HID = 2      # the hidden layer after GELU, (T, F)
SITE_MLP_RES = 3      # MLP residual branch, (T, D)


def dropout_threshold(rate: float) -> int:
    """uint32 cutoff: bits below it are dropped (P(drop) == rate)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def keep_mask(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """uint32 bits (held in int64) -> bool keep mask."""
    return bits >= dropout_threshold(rate)


def require_seed(seed, dropout_rate: float, op: str) -> None:
    """An active dropout needs an explicit seed."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError(
            f"{op}: dropout_rate={dropout_rate} > 0 requires an explicit "
            "int32 seed (derive one per call via prng.derive_seed); "
            "defaulting to 0 would reuse the same dropout mask every step")


def derive_seed(generator: torch.Generator) -> int:
    """Draw an int32 seed for a kernel call from a CPU generator.

    The generator lives on the CPU on purpose: the seed becomes a kernel
    argument, and drawing it on the device would synchronise every call.
    """
    if generator.device.type != "cpu":
        raise ValueError("derive_seed draws from a CPU torch.Generator, got "
                         f"one on {generator.device}")
    return int(torch.randint(0, _INT32_MAX, (), generator=generator))


def fold_in(seed: int, data: int) -> int:
    """Mix ``data`` into ``seed`` (splitmix64's finalizer): a new 63-bit
    seed for ``torch.Generator.manual_seed``, as ``jax.random.fold_in``
    derives a per-step key."""
    mask = (1 << 64) - 1
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit halves of a * b; a < 2**32 a Python int, b a
    uint32 held in int64. The product needs 64 bits unsigned and int64 has
    63, so b is split into 16-bit limbs."""
    lo = a * (b & 0xFFFF)               # < 2**48
    hi = a * (b >> 16)                  # < 2**48
    total_lo = lo + ((hi & 0xFFFF) << 16)   # < 2**49
    return (hi >> 16) + (total_lo >> 32), total_lo & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10. ``counter``: four uint32 tensors held in int64 (they
    broadcast against each other); ``key``: two Python ints. Returns the
    four output words as int64 tensors in [0, 2**32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: int, batch: int, heads: int, q_len: int, k_len: int,
                 device=None, batch_offset: int = 0,
                 key_word: int = 0) -> torch.Tensor:
    """The attention kernels' dropout bits: (batch, heads, q_len, k_len)
    uint32 values held in int64.

    bits[b, h, i, j] is word ``j % 4`` of Philox4x32-10 with key
    (seed, key_word) and counter (j // 4, i, h, batch_offset + b): a pure
    function of the seed and the four indices. ``key_word`` is 0 for the
    short-sequence kernels and :data:`FLASH_KEY_WORD` for flash attention.
    """
    arange = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    groups = (k_len + 3) // 4
    counter = (arange(groups).view(1, 1, 1, groups),
               arange(q_len).view(1, 1, q_len, 1),
               arange(heads).view(1, heads, 1, 1),
               (arange(batch) + batch_offset).view(batch, 1, 1, 1))
    words = philox4x32(counter, (seed, key_word))
    words = torch.broadcast_tensors(*words)
    bits = torch.stack(words, dim=-1).reshape(batch, heads, q_len, groups * 4)
    return bits[..., :k_len]


def elementwise_bits(seed: int, numel: int, device=None) -> torch.Tensor:
    """The standalone dropout kernel's bits: (numel,) uint32 values held in
    int64, for the row-major flat elements of a tensor.

    bits[e] is word ``e % 4`` of Philox4x32-10 with key (seed, 1) and
    counter (low 32 bits of e // 4, high 32 bits of e // 4, 0, 0): a pure
    function of the seed and the element index, so the bits of a flat
    prefix are the prefix of the bits.
    """
    group = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(group)
    words = philox4x32((group & _MASK32, group >> 32, zero, zero), (seed, 1))
    return torch.stack(words, dim=-1).reshape(-1)[:numel]


def block_site_bits(seed: int, site: int, batch: int, heads: int, rows: int,
                    cols: int, device=None,
                    frame_offset: int = 0) -> torch.Tensor:
    """The fused sub-block kernels' dropout bits of one site: (batch, heads,
    rows, cols) uint32 values held in int64.

    bits[b, h, i, j] is word ``j % 4`` of Philox4x32-10 with key
    (seed, 3 + site) and counter (j // 4, i, h, frame_offset + b). Site
    :data:`SITE_ATTN_W` draws (heads, T, T) a frame; the three elementwise
    sites draw (1, T, width). A frame's bits depend on its absolute index
    only, so a batch cut in two calls (the second with ``frame_offset``)
    draws the mask of the whole.
    """
    if site not in (SITE_ATTN_W, SITE_ATTN_RES, SITE_MLP_HID, SITE_MLP_RES):
        raise ValueError(f"unknown dropout site {site}")
    return dropout_bits(seed, batch, heads, rows, cols, device=device,
                        batch_offset=frame_offset,
                        key_word=BLOCK_KEY_WORD + site)
