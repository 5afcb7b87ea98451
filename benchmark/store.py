"""The training-from-disk cell's store: written in set-up from the seed in
the layout the port's reader takes (``<root>/<id[:4]>/<id>_data.pkl``
holding frames, actions and timesteps, and ``<id>_0.png`` / ``<id>_1.png``
CAD views), and read back by the reference with pickle and PIL alone.

``sequences`` distinct sequences are written, their lengths a fixed set
spread over [min_len, max_len] in the seed's order; each is listed under
``aliases`` ids by hard links (no bytes written), so that an epoch
outlasts the window as a user's epoch of thousands of steps does. Both
CAD views of a sequence are one image, so the reader's random choice of
view cannot change what a batch holds.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from benchmark import synthetic


def _path(root: str, file_id: str, suffix: str) -> str:
    return os.path.join(root, file_id[:4], f"{file_id}_{suffix}")


def sequence_lengths(params: Dict, seed: int) -> List[int]:
    n, lo, hi = params["sequences"], params["min_len"], params["max_len"]
    values = [lo + round(i * (hi - lo) / max(1, n - 1)) for i in range(n)]
    return synthetic.lengths_in_order(values, seed)


def write(root: str, params: Dict, seed: int, size: int) -> Dict[str, str]:
    """Write the store; returns {id: id of the sequence it holds}."""
    from PIL import Image

    rng = np.random.default_rng([seed, 7])
    owner = {}
    n = params["sequences"]
    for i, length in enumerate(sequence_lengths(params, seed)):
        file_id = f"{i:08d}"
        os.makedirs(os.path.dirname(_path(root, file_id, "")), exist_ok=True)
        data = {"frames": rng.integers(0, 256, (length, size, size, 3),
                                       dtype=np.uint8),
                "actions": synthetic.action_sequence(rng, length),
                "timesteps": np.arange(length, dtype=np.int64)}
        with open(_path(root, file_id, "data.pkl"), "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        cad = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(cad).save(_path(root, file_id, "0.png"))
        os.link(_path(root, file_id, "0.png"), _path(root, file_id, "1.png"))
        owner[file_id] = file_id
    for a in range(1, params["aliases"]):
        for i in range(n):
            src, dst = f"{i:08d}", f"{a * n + i:08d}"
            os.makedirs(os.path.dirname(_path(root, dst, "")), exist_ok=True)
            for suffix in ("data.pkl", "0.png", "1.png"):
                os.link(_path(root, src, suffix), _path(root, dst, suffix))
            owner[dst] = src
    return owner


def read(root: str, file_id: str) -> Dict[str, np.ndarray]:
    """The reference's reading of one sequence: frames, actions, CAD."""
    from PIL import Image

    with open(_path(root, file_id, "data.pkl"), "rb") as f:
        data = pickle.load(f)
    with Image.open(_path(root, file_id, "0.png")) as img:
        cad = np.asarray(img.convert("RGB"))
    return {"frames": np.asarray(data["frames"], dtype=np.uint8),
            "actions": np.asarray(data["actions"], dtype=np.int64),
            "cad_image": cad}


def batch(root: str, ids: List[str], bucket: int) -> Dict[str, np.ndarray]:
    """The batch of ``ids`` as the published loader pads it: frames with
    0 and actions with -1 up to ``bucket`` steps."""
    items = [read(root, i) for i in ids]
    frames = np.zeros((len(ids), bucket) + items[0]["frames"].shape[1:],
                      np.uint8)
    actions = np.full((len(ids), bucket, 7), -1, np.int64)
    for r, item in enumerate(items):
        n = len(item["frames"])
        frames[r, :n] = item["frames"]
        actions[r, :n] = item["actions"]
    return {"frames": frames, "actions": actions,
            "cad_image": np.stack([it["cad_image"] for it in items])}
