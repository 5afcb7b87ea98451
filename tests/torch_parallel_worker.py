"""Rank bodies for the port's multi-rank CPU tests (``tests/
test_torch_port_parallel*.py``). They run in processes started by
``videocad_tpu_torch.parallel.dryrun.launch`` over gloo, and import
torch and the port only (no jax): the tests compute the JAX references in
their own process and hand them over in a ``torch.save`` file."""

import json
import os
import signal

import numpy as np
import torch

from videocad_tpu_torch.models import create_model
from videocad_tpu_torch.parallel import distributed
from videocad_tpu_torch.parallel.collectives import all_reduce
from videocad_tpu_torch.parallel.mesh import create_hybrid_mesh, create_mesh
from videocad_tpu_torch.parallel.sharding import (gather_params,
                                                  param_shardings,
                                                  shard_model)
from videocad_tpu_torch.train.checkpoint import CheckpointHandler
from videocad_tpu_torch.train.objective import LossConfig
from videocad_tpu_torch.train.preempt import PreemptionGuard
from videocad_tpu_torch.train.state import create_sharded_train_state
from videocad_tpu_torch.train.steps import make_eval_step, make_train_step


def _mesh(shape):
    if "dcn" in shape:
        return create_hybrid_mesh(shape["dcn"], shape["data"], shape["model"])
    return create_mesh(shape["data"], shape["model"])


def _model(config, state_dict, mesh):
    model = create_model(config)
    model.load_state_dict(state_dict)
    shard_model(model, mesh)
    return model


def _steps(job, config, mesh, out):
    """``job["steps"]`` train steps of the global batch's rows of this
    rank: the loss and counters summed over the data group after each, the
    gathered parameters after steps 1 and the last, the eval step's."""
    model = _model(config, job["state_dict"], mesh)
    state = create_sharded_train_state(dict(model.named_parameters()),
                                       {"lr": 1e-3}, mesh)
    loss_config = LossConfig(**job["loss_config"])
    step = make_train_step(model, loss_config, mesh=mesh)
    batch_size = len(job["batch"]["actions"])
    local = {k: torch.from_numpy(v[mesh.rows(batch_size)])
             for k, v in job["batch"].items()}
    record = {"loss": [], "metrics": [], "params": {}}
    for i in range(job["steps"]):
        state, loss, metrics = step(state, local, 0)
        keys = sorted(metrics)
        summed = all_reduce(torch.stack([loss] + [metrics[k] for k in keys]),
                            mesh.data_group).tolist()
        record["loss"].append(summed[0])
        record["metrics"].append(dict(zip(keys, summed[1:])))
        if i + 1 in (1, job["steps"]):
            record["params"][i + 1] = {
                k: v.clone() for k, v in gather_params(state.params,
                                                       mesh).items()}
    eval_loss, eval_metrics = make_eval_step(model, loss_config,
                                             mesh=mesh)(local)
    record["eval_loss"] = all_reduce(eval_loss, mesh.data_group).item()
    record["eval_total"] = all_reduce(eval_metrics["total_predictions"],
                                      mesh.data_group).item()
    record["layout"] = param_shardings(model)
    # The replicated parameters are bit-equal across the model ranks.
    replicated = [p.detach().reshape(-1) for k, p in state.params.items()
                  if not record["layout"][k]]
    flat = torch.cat(replicated)
    record["replicated_equal"] = bool(torch.equal(
        all_reduce(flat, mesh.model_group, "max"),
        -all_reduce(-flat, mesh.model_group, "max")))
    out[job["name"]] = record
    return model, state


def _consensus(mesh, out):
    """The stop flag's global OR: no rank signaled, then SIGTERM to the
    last rank alone."""
    guard = PreemptionGuard(group=mesh.world_group).install()
    try:
        before = guard.consensus()
        if mesh.rank == mesh.grid.size - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        after = guard.consensus()
        signaled = all_reduce(torch.tensor([float(guard.signaled)]),
                              mesh.world_group).item()
    finally:
        guard.uninstall()
    out["consensus"] = {"before": before, "after": after,
                        "signaled_ranks": signaled}


def parity(spec: str, out_path: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize("cpu")
    spec = torch.load(spec, weights_only=False)
    mesh = _mesh(spec["mesh"])
    config = json.loads(spec["config"])
    out = {"rank_layout": (mesh.data_rank, mesh.model_rank)}
    model = state = None
    for job in spec["jobs"]:
        model, state = _steps(job, config, mesh, out)
    if spec.get("consensus"):
        _consensus(mesh, out)
    ckpt = spec.get("checkpoint")
    if ckpt:
        # Written under this mesh, for a single process to load; and the
        # single process's checkpoint restored into this mesh's shards.
        CheckpointHandler("mesh", ckpt, mesh).save(state, 0, 1.0)
        fresh = _model(config, spec["jobs"][0]["state_dict"], mesh)
        target = create_sharded_train_state(
            dict(fresh.named_parameters()), {"lr": 1e-3}, mesh)
        restored, meta = CheckpointHandler("single", ckpt, mesh).restore(
            "epoch_1", target)
        full = gather_params(restored.params, mesh)
        moments = restored.opt_state.state_dict()["state"]
        out["restored"] = {"step": restored.step, "epoch": meta["epoch"],
                           "params": full,
                           "exp_avg_shapes": [tuple(m["exp_avg"].shape)
                                              for m in moments.values()]}
    if mesh.rank == 0:
        torch.save(out, out_path)


def grid(out_path: str, shapes: list) -> None:
    """For each mesh shape: every rank's (rank, data rank, model rank,
    first row of a batch of eight), gathered on rank 0."""
    distributed.initialize("cpu")
    tables = []
    for shape in shapes:
        mesh = _mesh(shape)
        table = torch.zeros(mesh.grid.size, 4)
        table[mesh.rank] = torch.tensor([
            float(mesh.rank), float(mesh.data_rank), float(mesh.model_rank),
            float(mesh.rows(8).start)])
        tables.append(all_reduce(table, mesh.world_group).numpy())
    if distributed.rank() == 0:
        np.save(out_path, np.stack(tables))
