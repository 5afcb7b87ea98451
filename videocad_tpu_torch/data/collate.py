"""Batch assembly: -1 padding and static sequence-length buckets.

Port of ``videocad_tpu/data/collate.py`` (numpy only). Each batch is padded
up to one of a small set of lengths, so a run sees a handful of batch
shapes; actions pad with -1 (the losses ignore it), frames with 0, and the
timesteps are regenerated as ``arange`` (the stored ones are unused).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# Default buckets cover the 186-step max horizon (+1 prepended zero action).
DEFAULT_BUCKETS = (48, 96, 144, 192)


def bucket_length(max_len: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if max_len <= b:
            return b
    raise ValueError(f"Sequence length {max_len} exceeds largest bucket "
                     f"{buckets[-1]}")


def pad_to(array: np.ndarray, length: int, fill=-1) -> np.ndarray:
    pad = length - array.shape[0]
    if pad <= 0:
        return array[:length]
    padding = np.full((pad,) + array.shape[1:], fill, dtype=array.dtype)
    return np.concatenate([array, padding], axis=0)


def collate(items: List[Dict[str, np.ndarray]],
            buckets: Sequence[int] = DEFAULT_BUCKETS,
            fixed_length: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack per-sequence dicts into one padded batch.

    frames pad with 0 (uint8: the ignore mask comes from the actions, never
    from pixels); actions pad with -1.
    """
    max_len = max(item["frames"].shape[0] for item in items)
    length = fixed_length or bucket_length(max_len, buckets)
    batch = {
        "frames": np.stack([pad_to(i["frames"], length, fill=0) for i in items]),
        "actions": np.stack([pad_to(i["actions"], length, fill=-1) for i in items]),
        "cad_image": np.stack([i["cad_image"] for i in items]),
        "timesteps": np.tile(np.arange(length)[None], (len(items), 1)),
    }
    if all("multiview_images" in i for i in items):
        batch["multiview_images"] = np.stack(
            [i["multiview_images"] for i in items])
    batch["ids"] = [i.get("id", "") for i in items]
    return batch
