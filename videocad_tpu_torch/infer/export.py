"""Serving artifacts: a trained model packed into one ``.vcdx`` file.

Port of ``videocad_tpu/infer/export.py``. The JAX artifact ships StableHLO
programs from ``jax.export``, which the port cannot run. The port's
artifact keeps the same zip layout and adds no programs:

  <name>.vcdx  (a zip)
    config.json   the model config (the ``model_configs`` schema)
    meta.json     ``"format": "videocad_tpu_torch"``, the serving shapes
                  (``batch_size``, ``bucket_len``, ``image_size``), and
                  ``weight_quant``, ``lanes``, ``multiview``, ``num_views``,
                  ``has_rollout``, ``has_decode``
    params.npz    float32 weights, flattened by the JAX tree's ``/``
                  paths (``videocad_tpu/infer/export.py:_flatten_params``)

:func:`load_exported` rebuilds the model from ``config.json`` with the
port's code and returns an :class:`ExportedModel` whose methods are the
JAX one's, held to the shapes in ``meta.json``: a wrong shape raises, as a
shape-specialised program would. It reads a JAX artifact (format 3) too:
its ``config.json``, ``meta.json`` and ``params.npz``, ignoring the
``*.shlo`` programs. ``params.npz`` is full precision in both; the
artifact's ``weight_quant`` is applied at load, as in JAX. The JAX loader
cannot read a port artifact: it has no programs to deserialize.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from videocad_tpu_torch.infer.incremental import (incremental_decode_step,
                                                  init_decode_carry)
from videocad_tpu_torch.infer.multiplex import (init_mux_carry,
                                                mux_decode_step, open_lane)
from videocad_tpu_torch.infer.rollout import (check_weight_quant,
                                              decode_params,
                                              sequential_inference)
from videocad_tpu_torch.models.convert import (flat_jax_params,
                                               load_jax_params,
                                               state_dict_from_jax)
from videocad_tpu_torch.models.factory import create_model
from videocad_tpu_torch.models.videocadformer import GENCAD_IMAGE_SHAPE

FORMAT = "videocad_tpu_torch"
_FORMAT_VERSION = 1


def export_model(config: Dict[str, Any], model: nn.Module, batch_size: int,
                 bucket_len: int, out_path: str, with_rollout: bool = True,
                 weight_quant: str = "none", lanes: int = 0
                 ) -> Dict[str, Any]:
    """Write ``model`` (built from ``config``) to a ``.vcdx`` artifact;
    returns the meta dict.

    ``batch_size`` / ``bucket_len``: the serving shapes, as JAX's: the
    forward takes the teacher-shifted ``bucket_len - 1`` frames, the
    rollout and the decode horizon ``bucket_len``. ``weight_quant`` is
    recorded and applied at load; ``lanes`` > 0 serves that many
    multiplexed sessions (``ArtifactMuxEngine``). Both need action
    feedback, as in JAX.
    """
    cfg = model.config
    check_weight_quant(cfg, weight_quant)
    if lanes > 0 and not cfg.enable_past_actions:
        raise ValueError(
            "lanes > 0 serves the mux decode step, which needs action "
            "feedback (enable_past_actions)")
    meta = {
        "format": FORMAT,
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "batch_size": batch_size,
        "bucket_len": bucket_len,
        "image_size": cfg.image_size,
        "has_rollout": with_rollout,
        "has_decode": cfg.enable_past_actions,
        "weight_quant": weight_quant,
        "lanes": lanes,
        "multiview": cfg.num_views > 0,
        "num_views": cfg.num_views,
    }
    buf = io.BytesIO()
    np.savez(buf, **flat_jax_params(model.state_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("config.json", json.dumps(config, indent=2))
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        zf.writestr("params.npz", buf.getvalue())
    return meta


def artifact_lanes(meta: Dict) -> int:
    """Multiplexed lanes of an artifact: ``lanes`` (the port's) or
    ``mux_lanes`` (a JAX artifact's)."""
    return int(meta.get("lanes", meta.get("mux_lanes", 0)) or 0)


class ExportedModel:
    """A loaded artifact: the rebuilt model behind the JAX ExportedModel's
    methods, each held to the artifact's shapes. Inputs are numpy arrays or
    tensors; outputs are tensors on the model's device."""

    def __init__(self, config: Dict, meta: Dict, model: nn.Module):
        self.config = config
        self.meta = meta
        self.model = model
        self.device = model.device
        self.batch = meta["batch_size"]
        self.bucket_len = meta["bucket_len"]
        self.weight_quant = meta.get("weight_quant", "none")
        self.lanes = artifact_lanes(meta)
        self.multiview = bool(meta.get("multiview"))
        size = meta["image_size"]
        self.img = (size, size, 3)
        self.cad_hw = (GENCAD_IMAGE_SHAPE if config.get(
            "use_pretrained_cad_model") else self.img)
        self._session_params = None

    def _take(self, name: str, value, shape: Tuple[int, ...],
              dtype: torch.dtype) -> torch.Tensor:
        """``value`` on the device, or ValueError where a program traced
        for ``shape`` and ``dtype`` would refuse it."""
        x = torch.as_tensor(value, device=self.device)
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        return x

    def _views(self, multiview_images, rows: int) -> Optional[torch.Tensor]:
        """The multiview input: required by a multiview artifact, refused
        by the others (JAX's ``_mv_args``)."""
        if self.multiview:
            if multiview_images is None:
                raise ValueError(
                    "this artifact was exported for a multiview model "
                    f"(num_views={self.meta.get('num_views')}); "
                    "multiview_images is required")
            return self._take("multiview_images", multiview_images,
                              (rows, self.meta["num_views"]) + self.img,
                              torch.uint8)
        if multiview_images is not None:
            raise ValueError("artifact was exported without multiview "
                             "inputs; do not pass multiview_images")
        return None

    def _decode_params(self) -> Dict:
        """The session's decode tree (cast and fused, quantized under the
        artifact's ``weight_quant``), made once for the loaded model."""
        if self._session_params is None:
            self._session_params = decode_params(self.model,
                                                 self.weight_quant)
        return self._session_params

    def _require(self, what: str) -> None:
        if what == "rollout" and not self.meta.get("has_rollout"):
            raise ValueError("artifact was exported without a rollout")
        if what == "decode" and not self.meta.get("has_decode"):
            raise ValueError(
                "artifact has no incremental decode (exported from a model "
                "without action feedback)")
        if what == "mux" and not self.lanes:
            raise ValueError(
                "artifact has no mux serving lanes (export with lanes=N, "
                "cli/export_model.py --lanes)")

    @torch.no_grad()
    def forward(self, frames, actions, cad_image, multiview_images=None):
        """Teacher-forced forward: (cmd logits, param logits)."""
        t = self.bucket_len - 1
        inputs = {
            "frames": self._take("frames", frames,
                                 (self.batch, t) + self.img, torch.uint8),
            "actions": self._take("actions", actions, (self.batch, t, 7),
                                  torch.float32),
            "cad_image": self._take("cad_image", cad_image,
                                    (self.batch,) + self.cad_hw,
                                    torch.uint8)}
        views = self._views(multiview_images, self.batch)
        if views is not None:
            inputs["multiview_images"] = views
        return self.model(inputs)

    def rollout(self, frames, cad_image, multiview_images=None):
        """The autoregressive rollout over ``bucket_len`` ground-truth
        frames, under the artifact's ``weight_quant``."""
        self._require("rollout")
        return sequential_inference(
            self.model,
            self._take("frames", frames,
                       (self.batch, self.bucket_len) + self.img,
                       torch.uint8),
            self._take("cad_image", cad_image, (self.batch,) + self.cad_hw,
                       torch.uint8),
            weight_quant=self.weight_quant,
            multiview_images=self._views(multiview_images, self.batch))

    def decode_init(self, cad_image, multiview_images=None) -> Dict:
        """Start a serving session: CAD image -> decode carry."""
        self._require("decode")
        return init_decode_carry(
            self.model,
            self._take("cad_image", cad_image, (self.batch,) + self.cad_hw,
                       torch.uint8),
            self.bucket_len, self._views(multiview_images, self.batch))

    def decode_step(self, frame, carry: Dict):
        """One serving step: (carry, cmd logits, param logits)."""
        self._require("decode")
        return incremental_decode_step(
            self.model, self._decode_params(),
            self._take("frame", frame, (self.batch,) + self.img,
                       torch.uint8), carry)

    def mux_init(self) -> Dict:
        """The all-lanes-idle carry of the artifact's ``lanes``."""
        self._require("mux")
        return init_mux_carry(self.model, self.lanes, self.bucket_len,
                              multiview=self.multiview)

    def mux_open(self, carry: Dict, lane: int, cad_image,
                 multiview_images=None) -> Dict:
        """Claim ``lane`` for a session (a batch-1 CAD encode)."""
        self._require("mux")
        lane = int(lane)
        if not 0 <= lane < self.lanes:
            raise ValueError(f"lane {lane} out of range({self.lanes})")
        return open_lane(
            self.model, carry, lane,
            self._take("cad_image", cad_image, (1,) + self.cad_hw,
                       torch.uint8),
            self._views(multiview_images, 1))

    def mux_step(self, frames, active, carry: Dict):
        """One multiplexed tick: (carry, cmd logits (L, 5), param logits
        (L, 6, 1000)); inactive lanes are bit-frozen."""
        self._require("mux")
        return mux_decode_step(
            self.model, self._decode_params(),
            self._take("frames", frames, (self.lanes,) + self.img,
                       torch.uint8),
            self._take("active", active, (self.lanes,), torch.bool), carry)


def read_meta(path: str) -> Dict:
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))


def load_exported(path: str, device="cuda") -> ExportedModel:
    """Load a port artifact, or a JAX one (its ``*.shlo`` ignored), onto
    ``device``: the model is rebuilt from ``config.json`` and its weights
    read from ``params.npz`` (``models/convert.py:load_jax_params``)."""
    tree, config = load_jax_params(path)
    if config is None:
        raise ValueError(f"{path} is not a .vcdx artifact (no config.json)")
    model = create_model(config, device=device)
    model.load_state_dict(state_dict_from_jax(tree))
    return ExportedModel(config, read_meta(path), model)
