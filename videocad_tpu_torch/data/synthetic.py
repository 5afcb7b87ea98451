"""Synthetic in-memory batches for the train step's smoke runs and tests.

Port of ``random_action_sequence`` and ``synthetic_batch_feed`` of
``videocad_tpu/data/synthetic.py`` (numpy only): random but valid action
sequences (per-command param validity, end sentinel) and uint8 frames. The
same seed gives the same batch as the JAX package's feed. The on-disk
dataset writer comes with the data slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from videocad_tpu_torch.actions.vocab import (
    ACTION_PARAM_MASK,
    END_SENTINEL,
    NUM_COMMANDS,
)


def random_action_sequence(rng: np.random.Generator, length: int,
                           end_sentinel: bool = True) -> np.ndarray:
    """(length, 7) valid action vectors (zero seed row first)."""
    actions = np.full((length, 7), -1, dtype=np.int64)
    actions[0] = 0
    cmds = rng.integers(0, NUM_COMMANDS, size=length - 1)
    for t, cmd in enumerate(cmds, start=1):
        actions[t, 0] = cmd
        for p in range(6):
            if ACTION_PARAM_MASK[cmd][p]:
                actions[t, 1 + p] = rng.integers(0, 1000)
        if cmd == 1:  # repeat count only valid in the key window
            if not (200 <= actions[t, 3] < 250):
                actions[t, 4] = -1
    if end_sentinel:
        actions[-1] = [1, -1, -1, END_SENTINEL, -1, -1, -1]
    return actions


def synthetic_batch_feed(batch_size: int, seq_len: int, image_size: int = 224,
                         channels: int = 3, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """One in-memory uint8 batch shaped like the real pipeline's output."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(batch_size, seq_len, image_size,
                                        image_size, channels), dtype=np.uint8)
    actions = np.stack([random_action_sequence(rng, seq_len)
                        for _ in range(batch_size)])
    return {
        "frames": frames,
        "actions": actions.astype(np.float32),
        "cad_image": rng.integers(0, 256, size=(batch_size, image_size,
                                                image_size, channels),
                                  dtype=np.uint8),
        "timesteps": np.tile(np.arange(seq_len)[None], (batch_size, 1)),
    }
