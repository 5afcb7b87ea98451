"""The benchmark's inputs, made from the seed.

``action_sequence`` is a frozen copy of the port's synthetic-sequence
generator (``data/synthetic.py:random_action_sequence``): random valid
actions (each command's parameters only, "times" only for keys in the
window), a zero row first and the end sentinel last. Pixels are drawn on
the device with a ``torch.Generator`` in one call per tensor.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference.vocab import (ACTION_PARAM_MASK, END_SENTINEL,
                                       NUM_COMMANDS)


def action_sequence(rng: np.random.Generator, length: int) -> np.ndarray:
    """(length, 7) int64 actions."""
    actions = np.full((length, 7), -1, dtype=np.int64)
    actions[0] = 0
    cmds = rng.integers(0, NUM_COMMANDS, size=length - 1)
    for t, cmd in enumerate(cmds, start=1):
        actions[t, 0] = cmd
        for p in range(6):
            if ACTION_PARAM_MASK[cmd][p]:
                actions[t, 1 + p] = rng.integers(0, 1000)
        if cmd == 1 and not 200 <= actions[t, 3] < 250:
            actions[t, 4] = -1
    actions[-1] = [1, -1, -1, END_SENTINEL, -1, -1, -1]
    return actions


def padded_actions(rng: np.random.Generator, lengths: Sequence[int],
                   bucket: int) -> np.ndarray:
    """(B, bucket, 7) actions of the given lengths, padded with -1."""
    out = np.full((len(lengths), bucket, 7), -1, dtype=np.int64)
    for i, n in enumerate(lengths):
        out[i, :n] = action_sequence(rng, n)
    return out


def pixels(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 pixels of ``shape`` drawn on the device."""
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         device=device, generator=gen)


def real_frames(actions: np.ndarray) -> int:
    """Frames of a padded batch that the loss trains on: target steps
    (positions 1..T-1) that are not padding."""
    return int((actions[:, 1:, 0] != -1).sum())


def lengths_in_order(values: List[int], seed: int) -> List[int]:
    """The fixed set ``values`` in the order the seed gives."""
    order = np.random.default_rng(seed).permutation(len(values))
    return [values[i] for i in order]
