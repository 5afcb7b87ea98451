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

With a ``mesh`` (``parallel/mesh.py``) every rank calls ``save`` and
``restore`` at the same point: the model group gathers the split
parameters and Adam's moments (``parallel/sharding.py``), rank 0 writes the
same single-card ``state.pt`` and the other ranks wait at a barrier; a
restore reads the full tensors and slices them back to this rank's
shards. So a checkpoint written under any mesh loads in one process, and
the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from videocad_tpu_torch.parallel.collectives import barrier
from videocad_tpu_torch.parallel.sharding import (gather_like, gather_params,
                                                  shard_like, shard_params,
                                                  split_dims)
from videocad_tpu_torch.train.state import TrainState

_PAYLOAD = "state.pt"


class CheckpointHandler:
    """epoch_N / best_model checkpoints under <dir>/<experiment>/."""

    def __init__(self, experiment_name: str,
                 checkpoint_dir: str = "checkpoints", mesh=None):
        self.base = os.path.abspath(os.path.join(checkpoint_dir,
                                                 experiment_name))
        self.mesh = mesh
        os.makedirs(self.base, exist_ok=True)

    def _opt_names(self, state: TrainState):
        """The parameter names in the order of the optimizer's state dict
        (its groups' parameters, flattened)."""
        by_id = {id(p): k for k, p in state.params.items()}
        return [by_id[id(p)] for group in state.opt_state.param_groups
                for p in group["params"]]

    def _full_opt_state(self, state: TrainState) -> Dict[str, Any]:
        """Adam's state dict with the split parameters' moments gathered."""
        opt = state.opt_state.state_dict()
        if self.mesh is None or self.mesh.model_size == 1:
            return opt
        dims = split_dims(state.params)
        names = self._opt_names(state)
        for index, entry in opt["state"].items():
            dim = dims[names[index]]
            entry.update(gather_like(
                {k: entry[k] for k in ("exp_avg", "exp_avg_sq")},
                {"exp_avg": dim, "exp_avg_sq": dim}, self.mesh))
        return opt

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
        params = gather_params(state.params, self.mesh)
        opt_state = self._full_opt_state(state)
        if self.mesh is None or self.mesh.rank == 0:
            tmp = f"{path}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({
                "params": {k: p.cpu() for k, p in params.items()},
                "opt_state": opt_state,
                "step": state.step,
            }, os.path.join(tmp, _PAYLOAD))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"epoch": epoch + 1, "loss": float(loss)}, f)
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        if self.mesh is not None:
            barrier(self.mesh.world_group)
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
        local = shard_params(saved, params, self.mesh)
        with torch.no_grad():
            for key, param in params.items():
                param.copy_(local[key])
        return payload

    def restore(self, name: str, target: TrainState
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Restore into ``target``: its parameters are overwritten in
        place, its optimizer (built by the same ``make_optimizer`` call as
        the saved one: Adam's state dict names parameters by their position
        in its groups) takes the saved moments and step counts. Returns the
        state with the saved step, and the metadata."""
        payload = self.restore_params(name, target.params)
        opt = payload["opt_state"]
        dims = split_dims(target.params)
        names = self._opt_names(target)
        for index, entry in opt["state"].items():
            dim = dims[names[index]]
            entry.update(shard_like(
                {k: entry[k] for k in ("exp_avg", "exp_avg_sq")},
                {"exp_avg": dim, "exp_avg_sq": dim}, self.mesh))
        target.opt_state.load_state_dict(opt)
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
