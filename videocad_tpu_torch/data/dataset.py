"""Dataset index and readers over the sharded VideoCAD store.

Port of ``videocad_tpu/data/dataset.py``. Reads the on-disk layout
``<root>/<id[:4]>/<id>_data.pkl`` holding ``{"frames", "actions",
"timesteps"}`` plus CAD PNGs, and ``dataset_split.json`` naming the train,
val and test ids. Host side, numpy only; the move to the device happens in
``videocad_tpu_torch.data.pipeline``. The GenCAD CAD-image branch and the
multiview branch are not ported yet (ROADMAP slice 11), as in the model.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_split_ids(split_path: str) -> Dict[str, List[str]]:
    """dataset_split.json: {id: 'train'|'val'|'test'} -> per-split id lists."""
    with open(split_path) as f:
        split_map = json.load(f)
    splits: Dict[str, List[str]] = defaultdict(list)
    for name, split in split_map.items():
        splits[split].append(name)
    return dict(splits)


def scan_dataset(dataset_path: str, ids: Optional[Sequence[str]] = None
                 ) -> List[str]:
    """Find ``*_data.pkl`` files, optionally restricted to an id set."""
    id_set = set(ids) if ids is not None else None
    files = []
    for root, _dirs, names in os.walk(dataset_path):
        for name in names:
            if not name.endswith("_data.pkl"):
                continue
            file_id = name.split("_")[0]
            if id_set is not None and file_id not in id_set:
                continue
            files.append(os.path.join(root, name))
    files.sort()
    return files


class ImageLoader:
    """CAD-image lookup in the ``<dir>/<id[:4]>/<id>_*.png`` layout.

    With ``enable_random`` a random view PNG is selected per access: the
    train-time CAD-view augmentation.
    """

    def __init__(self, image_dir: str, enable_random: bool = False,
                 seed: int = 0):
        self.image_dir = image_dir
        self.enable_random = enable_random
        self._rng = random.Random(seed)
        mapping = defaultdict(list)
        for root, _dirs, names in os.walk(image_dir):
            for name in names:
                if name.endswith(".png"):
                    mapping[name.split("_")[0]].append(os.path.join(root, name))
        for paths in mapping.values():
            paths.sort()
        self.image_mapping = dict(mapping)

    def get_path(self, image_id: str) -> str:
        paths = self.image_mapping.get(image_id)
        if not paths:
            raise FileNotFoundError(
                f"No PNG for id {image_id} under {self.image_dir}")
        if self.enable_random:
            return self._rng.choice(paths)
        for p in paths:  # prefer the canonical _0 view
            if p.endswith("_0.png"):
                return p
        return paths[0]

    def get_image(self, image_id: str) -> np.ndarray:
        return read_image(self.get_path(image_id))


def read_image(path: str) -> np.ndarray:
    """Read a PNG as uint8 (H, W, 3)."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_u8(img: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear-resize a uint8 (H, W[, C]) image to (H', W')."""
    from PIL import Image
    h, w = size_hw
    if img.shape[:2] == (h, w):
        return img
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


class VideoCADDataset:
    """Per-sequence access: index -> {frames u8, actions, cad_image u8, id}."""

    def __init__(self, dataset_path: str, ids: Optional[Sequence[str]] = None,
                 image_dir: Optional[str] = None, enable_random: bool = False,
                 view_ids: Optional[Sequence[str]] = None,
                 multiview_dir: Optional[str] = None, seed: int = 0,
                 image_size: Optional[int] = None, gencad: bool = False):
        """``image_size``: target (square) resolution; frames and the CAD
        image are resized at load when they differ. None resizes the CAD
        image to the frames' resolution (a store whose PNGs differ in size
        must still collate) and leaves the frames as stored."""
        if gencad:
            raise NotImplementedError(
                "the GenCAD CAD-image branch (gencad=True) is not ported yet "
                "(ROADMAP slice 11)")
        if view_ids or multiview_dir:
            raise NotImplementedError(
                "multiview images (view_ids, multiview_dir) are not ported "
                "yet (ROADMAP slice 11)")
        self.data_files = scan_dataset(dataset_path, ids)
        if not self.data_files:
            raise ValueError(f"No *_data.pkl under {dataset_path}")
        self.image_loader = ImageLoader(image_dir or dataset_path,
                                        enable_random, seed)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.data_files)

    def sequence_id(self, idx: int) -> str:
        return os.path.basename(self.data_files[idx]).split("_")[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # The store is the program's own or the user's own dataset: pickle
        # is its format.
        with open(self.data_files[idx], "rb") as f:
            data = pickle.load(f)
        file_id = self.sequence_id(idx)
        frames = np.asarray(data["frames"], dtype=np.uint8)
        if self.image_size and frames.shape[1:3] != (self.image_size,) * 2:
            frames = np.stack([resize_u8(f, (self.image_size,) * 2)
                               for f in frames])
        target = ((self.image_size,) * 2 if self.image_size
                  else tuple(frames.shape[1:3]))
        cad = resize_u8(self.image_loader.get_image(file_id), target)
        return {
            "frames": frames,
            "actions": np.asarray(data["actions"], dtype=np.float32),
            "cad_image": cad,
            "id": file_id,
        }

    def validate(self, indices: Optional[Sequence[int]] = None):
        """Check the stored actions' ranges, on demand; raises on the first
        file that breaks them."""
        for i in indices if indices is not None else range(len(self)):
            actions = self[i]["actions"]
            if not ((actions[:, 0] >= 0) & (actions[:, 0] <= 4)).all():
                raise ValueError(f"bad cmd in {self.data_files[i]}")
            if not ((actions[:, 1:] >= -1) & (actions[:, 1:] <= 999)).all():
                raise ValueError(f"bad params in {self.data_files[i]}")
