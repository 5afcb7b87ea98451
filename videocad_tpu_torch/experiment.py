"""Experiment orchestration: named configs, grid sweeps, result JSON layout.

Port of ``videocad_tpu/experiment.py``: builds an experiment name, saves
``params.json`` and ``training_config.json`` under ``logs/<name>/``, makes
the model from the named JSON config, trains, evaluates on the test split
(plus the optional rollout evaluation) and writes ``results.json`` and
``seq_results.json``. List-valued params expand to a cartesian grid. A
``train_config`` block inside a model config overrides the training config
(``experiment_name`` among it, which is how a second run finds the
checkpoints of the first to resume from); the experiment's directory is the
one the trainer logs to. A ``state_dict`` key warm-starts the model from a
port checkpoint, JAX weights or a reference torch checkpoint (``.pt``), whose
ViT generation is folded into the model config before the model is built.

With a ``mesh`` every rank runs the experiment: each builds the model from
the same seed and warm start, the trainer splits it over the mesh
(``train/trainer.py``), and only rank 0 writes the JSON files.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Any, Dict, Optional, Tuple

import torch

from videocad_tpu_torch.models.factory import create_model
from videocad_tpu_torch.train.objective import (REFERENCE_CMD_WEIGHTS,
                                                LossConfig)
from videocad_tpu_torch.train.trainer import Trainer
from videocad_tpu_torch.utils.io import load_json, save_json


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")


def default_loss_config(training_config: Dict,
                        class_weights_path: Optional[str] = None
                        ) -> LossConfig:
    """LossConfig from a class_weights.json (dataset statistics) or the
    published label weights."""
    if class_weights_path and os.path.exists(class_weights_path):
        weights = load_json(class_weights_path)
        return LossConfig.from_class_weights(
            weights, use_mse=training_config.get("use_mse", True))
    return LossConfig(
        cmd_weights=REFERENCE_CMD_WEIGHTS,
        use_mse=training_config.get("use_mse", True))


def read_torch_checkpoint(path: str, model_params: Dict
                          ) -> Tuple[Dict, Dict]:
    """A reference torch checkpoint (``.pt`` / ``.pth``) as (the model
    params with the overrides its vit_pytorch generation implies merged
    in, its weights as the JAX parameter tree)."""
    from videocad_tpu_torch.models.torch_checkpoint import (
        convert_state_dict, detect_config_overrides)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    model_params = dict(model_params, **detect_config_overrides(sd))
    return model_params, convert_state_dict(sd, model_params)


def load_warm_start(model, path: str) -> None:
    """Load the weights at ``path`` into ``model``: a port checkpoint
    directory (``<dir>/<experiment>/<name>``), JAX weights (a
    ``params.npz`` or a ``.vcdx`` artifact), or a reference torch
    checkpoint (``.pt`` / ``.pth``, whose vit_pytorch generation must be
    the one the model was built for: :class:`Experiment` builds it so)."""
    if path.endswith((".pt", ".pth")):
        from videocad_tpu_torch.models.convert import state_dict_from_jax
        params = dataclasses.asdict(model.config)
        detected, tree = read_torch_checkpoint(path, params)
        changed = {k: v for k, v in detected.items() if params.get(k) != v}
        if changed:
            raise ValueError(
                f"{path} is a checkpoint of another ViT generation than "
                f"the model's: build the model with {changed}")
        model.load_state_dict(state_dict_from_jax(tree))
        return
    if path.endswith((".npz", ".vcdx")):
        from videocad_tpu_torch.models.convert import (load_jax_params,
                                                       state_dict_from_jax)
        tree, _ = load_jax_params(path)
        model.load_state_dict(state_dict_from_jax(tree))
        return
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    base, name = os.path.split(path.rstrip("/"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    CheckpointHandler(os.path.basename(base), os.path.dirname(base) or "."
                      ).restore_params(name, dict(model.named_parameters()))


class Experiment:
    def __init__(self, train_pipe, val_pipe, test_pipe, training_config: Dict,
                 device="cuda", log_dir: str = "logs",
                 class_weights_path: Optional[str] = "class_weights.json",
                 mesh=None):
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0
        self.train_pipe = train_pipe
        self.val_pipe = val_pipe
        self.test_pipe = test_pipe
        self.training_config = dict(training_config)
        self.device = torch.device(device)
        self.log_dir = log_dir
        self.class_weights_path = class_weights_path

    def _experiment_name(self, params: Dict, name: str = "") -> str:
        if name:
            return f"{name}_{_timestamp()}"
        parts = []
        for v in params.values():
            if isinstance(v, list):
                parts.append("_".join(str(s) for s in v))
            else:
                parts.append(str(v))
        return f"{_timestamp()}_{'_'.join(parts)}"

    def run_with_params(self, experiment_params: Dict[str, Any],
                        name: str = "") -> Dict:
        training_config = dict(
            self.training_config,
            experiment_name=self._experiment_name(experiment_params, name))
        training_config.update(experiment_params.get("train_config", {}))
        exp_dir = os.path.join(self.log_dir,
                               training_config["experiment_name"])

        state_dict_path = experiment_params.get("state_dict")
        torch_tree = None
        if state_dict_path and state_dict_path.endswith((".pt", ".pth")):
            # The checkpoint's vit_pytorch generation can flip
            # vit_patch_norm / vit_final_norm: merged in before the model
            # is built and params.json written, which must describe the
            # model that is trained.
            experiment_params, torch_tree = read_torch_checkpoint(
                state_dict_path, experiment_params)
        model = create_model(
            experiment_params, device=self.device,
            generator=torch.Generator().manual_seed(
                training_config.get("seed", 0)))
        os.makedirs(exp_dir, exist_ok=True)
        if self.main:
            save_json(experiment_params, os.path.join(exp_dir,
                                                      "params.json"))
            save_json(training_config,
                      os.path.join(exp_dir, "training_config.json"))
        if torch_tree is not None:
            from videocad_tpu_torch.models.convert import state_dict_from_jax
            model.load_state_dict(state_dict_from_jax(torch_tree))
        elif state_dict_path:
            load_warm_start(model, state_dict_path)

        loss_config = default_loss_config(training_config,
                                          self.class_weights_path)
        trainer = Trainer(model, self.train_pipe, self.val_pipe,
                          self.test_pipe, training_config, loss_config,
                          log_dir=self.log_dir, mesh=self.mesh)
        if training_config.get("resume", False):
            trainer.resume()
        trainer.train(training_config.get("epochs", 100))

        results = trainer.evaluate(mode="test")
        if self.main:
            save_json(results, os.path.join(exp_dir, "results.json"))
        if training_config.get("sequential", False):
            seq_results = trainer.sequential_evaluate(mode="test")
            if self.main:
                save_json(seq_results, os.path.join(exp_dir,
                                                    "seq_results.json"))
        return results

    def run_grid(self, experiment_params: Dict[str, Any]):
        """Cartesian product over list-valued params."""
        listed = {k: v if isinstance(v, list) else [v]
                  for k, v in experiment_params.items()}
        results = []
        for combo in itertools.product(*listed.values()):
            results.append(self.run_with_params(dict(zip(listed, combo))))
        return results

    def run_with_config(self, config_path, config_name: str = ""):
        configs = load_json(config_path) if isinstance(config_path, str) \
            else config_path
        if config_name:
            return self.run_with_params(configs[config_name], config_name)
        return {name: self.run_with_params(params, name)
                for name, params in configs.items()}
