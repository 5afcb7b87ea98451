"""Checkpoints with true resume.

Port of ``videocad_tpu/train/checkpoint.py``: the same surface (``save``,
``restore``, ``latest_epoch``, ``wait``) and directory layout
(``<dir>/<experiment>/epoch_N/`` or ``best_model/``, with ``meta.json``
holding ``epoch`` and ``loss`` inside). A checkpoint is the whole
:class:`~videocad_tpu_torch.train.state.TrainState`: the parameters (float32
whatever the compute dtype), Adam's state dict (both moments and its step
counts) and ``TrainState.step``, written by ``torch.save`` into
``state.pt``. ``restore`` resumes training exactly where it stopped.

A directory is written under a temporary name and renamed into place, so a
run cut during a save leaves litter beside the checkpoints, never a
half-written ``epoch_N``; ``latest_epoch`` takes only ``epoch_<digits>``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from videocad_tpu_torch.train.state import TrainState

_PAYLOAD = "state.pt"


class CheckpointHandler:
    """epoch_N / best_model checkpoints under <dir>/<experiment>/."""

    def __init__(self, experiment_name: str,
                 checkpoint_dir: str = "checkpoints"):
        self.base = os.path.abspath(os.path.join(checkpoint_dir,
                                                 experiment_name))
        os.makedirs(self.base, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.base, name)

    def save(self, state: TrainState, epoch: int, loss: float,
             is_best: bool = False, name: Optional[str] = None) -> str:
        """Save a checkpoint; returns its directory.

        ``name`` may be arbitrary, but ``latest_epoch()`` (and thus
        ``Trainer.resume`` with no explicit name) only considers
        ``epoch_<N>`` directories with a purely numeric suffix.
        """
        name = name or ("best_model" if is_best else f"epoch_{epoch + 1}")
        path = self._path(name)
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({
            "params": {k: p.detach().cpu() for k, p in state.params.items()},
            "opt_state": state.opt_state.state_dict(),
            "step": state.step,
        }, os.path.join(tmp, _PAYLOAD))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": epoch + 1, "loss": float(loss)}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        return path

    def restore_params(self, name: str, params) -> Dict[str, Any]:
        """The weights alone, for a warm start or for serving: overwrite
        ``params`` (``dict(model.named_parameters())``) in place. Returns
        the checkpoint's payload (``params``, ``opt_state``, ``step``)."""
        path = self._path(name)
        payload = torch.load(os.path.join(path, _PAYLOAD),
                             map_location="cpu", weights_only=True)
        saved = payload["params"]
        if set(saved) != set(params):
            raise ValueError(
                f"checkpoint {path} holds other parameters than the model: "
                f"{sorted(set(saved) ^ set(params))[:5]} ...")
        with torch.no_grad():
            for key, param in params.items():
                param.copy_(saved[key])
        return payload

    def restore(self, name: str, target: TrainState
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Restore into ``target``: its parameters are overwritten in
        place, its optimizer (built by the same ``make_optimizer`` call as
        the saved one: Adam's state dict names parameters by their position
        in its groups) takes the saved moments and step counts. Returns the
        state with the saved step, and the metadata."""
        payload = self.restore_params(name, target.params)
        target.opt_state.load_state_dict(payload["opt_state"])
        meta = {}
        meta_path = os.path.join(self._path(name), "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return dataclasses.replace(target, step=int(payload["step"])), meta

    def latest_epoch(self) -> Optional[str]:
        # Only finished 'epoch_<N>' directories: a run cut during a save
        # leaves 'epoch_N.tmp-*' beside them, which must neither break the
        # int() parse nor win the max.
        epochs = []
        for d in os.listdir(self.base):
            if not d.startswith("epoch_"):
                continue
            suffix = d.split("_", 1)[1]
            if suffix.isdigit():
                epochs.append((int(suffix), d))
        if not epochs:
            return None
        return max(epochs)[1]

    def wait(self):
        """Saves are synchronous: nothing to wait for."""
