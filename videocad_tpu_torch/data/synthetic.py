"""Synthetic data: in-memory batches and on-disk datasets, from a seed.

Port of ``videocad_tpu/data/synthetic.py`` (numpy only): random but valid
action sequences (per-command param validity, end sentinel) and uint8
frames, either as one in-memory batch or written through the sharded store
the dataset reader reads. The same seed gives the same batch, and the same
files, as the JAX package's functions.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Optional

import numpy as np

from videocad_tpu_torch.actions.vocab import (
    ACTION_PARAM_MASK,
    END_SENTINEL,
    NUM_COMMANDS,
)
from videocad_tpu_torch.etl.dataset_gen import shard_path


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


def synthetic_sequence(rng: np.random.Generator, length: int,
                       image_size: int = 224, channels: int = 3
                       ) -> Dict[str, np.ndarray]:
    return {
        "frames": rng.integers(0, 256, size=(length, image_size, image_size,
                                             channels), dtype=np.uint8),
        "actions": random_action_sequence(rng, length),
        "timesteps": np.arange(length, dtype=np.int64),
    }


def write_synthetic_dataset(out_dir: str, num_sequences: int = 8,
                            min_len: int = 6, max_len: int = 12,
                            image_size: int = 32, seed: int = 0,
                            split_path: Optional[str] = None,
                            val_fraction: float = 0.25) -> Dict[str, str]:
    """Write a sharded dataset (pickles, two CAD view PNGs per sequence)
    and, with ``split_path``, its split json; returns {id: split}. The
    first ``1 - 2 * val_fraction`` of the sequences are train, the next
    ``val_fraction`` val, the rest test."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    split_map = {}
    n_train = int(num_sequences * (1 - 2 * val_fraction)) or 1
    n_val = int(num_sequences * val_fraction) or 1
    for i in range(num_sequences):
        file_id = f"{i:08d}"
        length = int(rng.integers(min_len, max_len + 1))
        data = synthetic_sequence(rng, length, image_size)
        with open(shard_path(out_dir, file_id, "pkl", "data"), "wb") as f:
            pickle.dump(data, f)
        for view in range(2):
            png = data["frames"][0] if view == 0 else data["frames"][-1]
            Image.fromarray(png).save(
                shard_path(out_dir, file_id, "png", str(view)))
        split_map[file_id] = ("train" if i < n_train else
                              "val" if i < n_train + n_val else "test")
    if split_path:
        with open(split_path, "w") as f:
            json.dump(split_map, f)
    return split_map


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
