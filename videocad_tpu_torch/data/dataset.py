"""Dataset index and readers over the sharded VideoCAD store.

Port of ``videocad_tpu/data/dataset.py``. Reads the on-disk layout
``<root>/<id[:4]>/<id>_data.pkl`` holding ``{"frames", "actions",
"timesteps"}`` plus CAD PNGs, and ``dataset_split.json`` naming the train,
val and test ids. Host side, numpy only; the move to the device happens in
``videocad_tpu_torch.data.pipeline``. The GenCAD CAD-image branch
(``gencad=True``) needs OpenCV for its Canny edges (``cv2``, imported only
there); the multiview branch (``view_ids``) reads one PNG a view.
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


def gencad_cad_image(rgb: np.ndarray) -> np.ndarray:
    """The GenCAD CAD-image branch, host side: Canny(100, 200) ->
    3-channel -> resize (shorter edge 256, bilinear) -> centre crop 256,
    returning uint8 (256, 256, 3). The normalization to [-1, 1] happens on
    the device (``ops/preprocess.py:normalize_only``).

    torchvision's Resize / CenterCrop semantics, on the RGB image the
    loader reads. Needs OpenCV (``cv2``), imported here only."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            "the GenCAD CAD-image branch (gencad=True, "
            "use_pretrained_cad_model) needs OpenCV (cv2) for its Canny "
            "edges, and it is not installed") from exc
    from PIL import Image

    edges = cv2.Canny(rgb, 100, 200)
    img = np.repeat(edges[:, :, None], 3, axis=2)
    h, w = img.shape[:2]
    # Resize(256): the shorter edge to 256, the other scaled, bilinear.
    if h <= w:
        nh, nw = 256, int(256 * w / h)
    else:
        nh, nw = int(256 * h / w), 256
    pil = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    # CenterCrop(256).
    left = int(round((nw - 256) / 2.0))
    top = int(round((nh - 256) / 2.0))
    return np.asarray(pil.crop((left, top, left + 256, top + 256)))


def _view_path(base_dir: str, file_id: str, view_id: str) -> str:
    """``<base>/<id[:4]>/<id>_<view>.png``: views live in a store root."""
    return os.path.join(base_dir, file_id[:4], f"{file_id}_{view_id}.png")


class VideoCADDataset:
    """Per-sequence access: index -> {frames u8, actions, cad_image u8, id}."""

    def __init__(self, dataset_path: str, ids: Optional[Sequence[str]] = None,
                 image_dir: Optional[str] = None, enable_random: bool = False,
                 view_ids: Optional[Sequence[str]] = None,
                 multiview_dir: Optional[str] = None, seed: int = 0,
                 image_size: Optional[int] = None, gencad: bool = False):
        """``image_size``: target (square) resolution; frames, the CAD
        image and the views are resized at load when they differ. None
        resizes the CAD image and the views to the frames' resolution (a
        store whose PNGs differ in size must still collate) and leaves the
        frames as stored. ``gencad``: the CAD image is the 256 x 256 x 3
        Canny edge image (:func:`gencad_cad_image`). ``view_ids``: the
        views each item carries as ``multiview_images`` (V, H, W, 3), read
        from ``multiview_dir`` (a store root; default: the dataset's)."""
        self.data_files = scan_dataset(dataset_path, ids)
        if not self.data_files:
            raise ValueError(f"No *_data.pkl under {dataset_path}")
        self.image_loader = ImageLoader(image_dir or dataset_path,
                                        enable_random, seed)
        self.view_ids = list(view_ids) if view_ids else []
        self.multiview_dir = multiview_dir
        self.image_size = image_size
        self.gencad = gencad

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
        cad = self.image_loader.get_image(file_id)
        cad = gencad_cad_image(cad) if self.gencad else resize_u8(cad,
                                                                  target)
        item = {
            "frames": frames,
            "actions": np.asarray(data["actions"], dtype=np.float32),
            "cad_image": cad,
            "id": file_id,
        }
        if self.view_ids:
            base_dir = self._views_root(idx)
            item["multiview_images"] = np.stack([
                resize_u8(read_image(_view_path(base_dir, file_id, view)),
                          target) for view in self.view_ids])
        return item

    def _views_root(self, idx: int) -> str:
        """The store root the views of item ``idx`` live under:
        ``multiview_dir``, else the dataset root above the item's
        ``<id[:4]>`` folder."""
        return self.multiview_dir or os.path.dirname(
            os.path.dirname(self.data_files[idx]))

    def check_multiview_availability(self):
        """Check that every item has every requested view PNG, up front;
        raises listing what is missing."""
        missing = {}
        for idx in range(len(self)):
            file_id = self.sequence_id(idx)
            base_dir = self._views_root(idx)
            for view in self.view_ids:
                if not os.path.exists(_view_path(base_dir, file_id, view)):
                    missing.setdefault(file_id, []).append(view)
        if missing:
            examples = "; ".join(
                f"{fid}: {views}" for fid, views in list(missing.items())[:5])
            raise ValueError(
                f"{len(missing)} samples missing requested views ({examples})")

    def validate(self, indices: Optional[Sequence[int]] = None):
        """Check the stored actions' ranges, on demand; raises on the first
        file that breaks them."""
        for i in indices if indices is not None else range(len(self)):
            actions = self[i]["actions"]
            if not ((actions[:, 0] >= 0) & (actions[:, 0] <= 4)).all():
                raise ValueError(f"bad cmd in {self.data_files[i]}")
            if not ((actions[:, 1:] >= -1) & (actions[:, 1:] <= 999)).all():
                raise ValueError(f"bad params in {self.data_files[i]}")
