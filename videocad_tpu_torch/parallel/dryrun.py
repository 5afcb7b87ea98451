"""A multi-rank run of the train, eval, rollout and checkpoint paths.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``:
:func:`dryrun_multichip` starts ``n`` ranks (one process each, over gloo on
the CPU, or sharing one card with their compute on it) at data n/2 x model
2, and each runs, on a reduced-width flagship whose every split rule fires:

  1. one full train step (forward, backward, the summed gradients, the
     global-norm clip, Adam on the shards);
  2. one teacher-forced eval step;
  3. a KV-cached ``sequential_inference`` on its rows;
  4. a checkpoint save (gathered, written by rank 0), its restore into the
     live shards, and a resumed step.

Rank 0 prints ``dryrun_multichip OK: ...``. :func:`launch` is the
launcher it uses, for any function ``module:name`` of the repository::

    python -c "from videocad_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, 'cpu')"
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from importlib import import_module
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, target: str, args: Optional[Dict] = None,
           timeout: float = 600.0, env: Optional[Dict[str, str]] = None,
           watch: Optional[Callable[[List[subprocess.Popen], List[str]],
                                    None]] = None) -> List[str]:
    """Run ``target`` (``"module:function"``, called with ``**args``) in
    ``n`` rank processes and wait for all; returns each rank's standard
    output. The ranks get ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``LOCAL_RANK``, as from ``torchrun``. If a rank fails
    or the time runs out, every rank is killed and the error raised with
    the failing rank's output. ``watch(processes, output paths)`` is
    called while they run (to signal a rank, for one)."""
    port = free_port()
    procs = []
    outs = []
    folder = tempfile.mkdtemp(prefix="vct_ranks_")
    for rank in range(n):
        rank_env = dict(os.environ, **(env or {}))
        rank_env.update(
            RANK=str(rank), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port),
            LOCAL_RANK=str(rank),
            PYTHONPATH=str(REPO) + os.pathsep + rank_env.get("PYTHONPATH",
                                                             ""),
            VCT_TARGET=target, VCT_ARGS=json.dumps(args or {}))
        outs.append(os.path.join(folder, f"rank{rank}.log"))
        with open(outs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from videocad_tpu_torch.parallel.dryrun import "
                 "rank_main; rank_main()"],
                env=rank_env, cwd=str(REPO), stdout=out,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            if watch is not None:
                watch(procs, outs)
            time.sleep(0.05)
        else:
            failed = next((i for i, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for path in outs:
        with open(path) as out:
            texts.append(out.read())
    shutil.rmtree(folder, ignore_errors=True)
    if failed is not None or any(p.returncode != 0 for p in procs):
        rank = failed if failed is not None else 0
        raise RuntimeError(
            f"{target}: rank {rank} of {n} failed (exit codes "
            f"{[p.returncode for p in procs]}, time limit {timeout} s):\n"
            f"{texts[rank][-6000:]}")
    return texts


def rank_main() -> None:
    """A rank's entry: call the target named in the environment."""
    module, name = os.environ["VCT_TARGET"].split(":")
    getattr(import_module(module), name)(**json.loads(
        os.environ["VCT_ARGS"]))


def dryrun_config() -> Dict:
    """The flagship at reduced widths (JAX's dryrun widths): every split
    rule still fires at model = 2."""
    from videocad_tpu_torch.models.factory import flagship_config
    return dict(flagship_config(), hidden_size=256, num_decoder_layers=4,
                dim_feedforward=256, image_size=64, vit_dim=128,
                vit_depth=2, vit_heads=4, vit_head_dim=32, vit_mlp_dim=128,
                dtype="float32", remat_encoder=False)


def _dryrun_body(device: str = "cpu", backend: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None) -> None:
    import numpy as np
    import torch

    from videocad_tpu_torch.data.synthetic import synthetic_batch_feed
    from videocad_tpu_torch.infer.rollout import sequential_inference
    from videocad_tpu_torch.models import create_model
    from videocad_tpu_torch.parallel import distributed
    from videocad_tpu_torch.parallel.collectives import all_reduce, barrier
    from videocad_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from videocad_tpu_torch.parallel.sharding import shard_model
    from videocad_tpu_torch.train.checkpoint import CheckpointHandler
    from videocad_tpu_torch.train.objective import (REFERENCE_CMD_WEIGHTS,
                                                    LossConfig)
    from videocad_tpu_torch.train.state import create_sharded_train_state
    from videocad_tpu_torch.train.steps import (make_eval_step,
                                                make_train_step)

    torch.set_num_threads(1)
    dev = distributed.local_device(device)
    distributed.initialize(dev, backend)
    n = distributed.world_size()
    model_axis = 2 if n % 2 == 0 and n > 1 else 1
    data_axis = n // model_axis
    mesh = create_mesh(data_axis, model_axis)
    main = mesh.rank == 0
    loss_config = LossConfig(cmd_weights=REFERENCE_CMD_WEIGHTS, use_mse=True)
    model = create_model(dryrun_config(), device=dev)
    layout = shard_model(model, mesh)
    assert sum(bool(spec) for spec in layout.values()) > 0 or n == 1
    state = create_sharded_train_state(dict(model.named_parameters()),
                                       {"lr": 1e-4}, mesh)
    feed = synthetic_batch_feed(batch_size=2 * data_axis, seq_len=8,
                                image_size=64, channels=3, seed=1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in shard_batch(mesh, feed).items()}

    # 1. One full train step.
    train_step = make_train_step(model, loss_config, noise=True, mesh=mesh)
    state, loss, metrics = train_step(state, batch, 2)
    total = all_reduce(torch.stack([loss, metrics["total_predictions"]]),
                       mesh.data_group).tolist()
    assert np.isfinite(total[0]) and total[1] > 0, total
    if main:
        print(f"dryrun train step OK: loss={total[0]:.4f}", flush=True)

    # 2. One teacher-forced eval step.
    eval_loss, eval_metrics = make_eval_step(model, loss_config,
                                             mesh=mesh)(batch)
    values = all_reduce(torch.stack([eval_loss,
                                     eval_metrics["total_predictions"]]),
                        mesh.data_group).tolist()
    assert np.isfinite(values[0]) and values[1] > 0, values
    if main:
        print(f"dryrun eval step OK: loss={values[0]:.4f}", flush=True)

    # 3. A KV-cached rollout on this rank's rows.
    cmds, param_logits = sequential_inference(model, batch["frames"],
                                              batch["cad_image"])
    assert cmds.shape[:2] == batch["frames"].shape[:2]
    assert param_logits.shape[2:] == (6, 1000)
    assert bool(torch.isfinite(cmds).all())
    if main:
        print("dryrun rollout OK", flush=True)

    # 4. Checkpoint round trip: gathered, written by rank 0, restored into
    # the live shards, one resumed step.
    root = checkpoint_dir or tempfile.gettempdir()
    handler = CheckpointHandler(f"dryrun_{os.environ['MASTER_PORT']}",
                                checkpoint_dir=root, mesh=mesh)
    handler.save(state, epoch=0, loss=total[0])
    live = {k: p.detach().clone() for k, p in state.params.items()}
    with torch.no_grad():
        for p in state.params.values():
            p.zero_()
    restored, meta = handler.restore("epoch_1", state)
    assert meta["epoch"] == 1 and restored.step == state.step
    for k, p in restored.params.items():
        assert torch.equal(p.detach(), live[k]), k
    restored, loss2, _ = train_step(restored, batch, 3)
    resumed = all_reduce(loss2[None], mesh.data_group).item()
    assert np.isfinite(resumed), resumed
    barrier(mesh.world_group)
    if main:
        import shutil
        shutil.rmtree(handler.base, ignore_errors=True)
        print("checkpoint resume OK", flush=True)
        print(f"dryrun_multichip OK: {n} ranks (data={data_axis}, "
              f"model={model_axis}), loss={total[0]:.4f}", flush=True)


def dryrun_multichip(n: int, device: str = "cpu",
                     timeout: float = 600.0) -> str:
    """Run :func:`_dryrun_body` in ``n`` ranks; prints and returns rank
    0's output. ``device`` "cpu" (gloo) or "cuda" (ranks that share one
    card: gloo, compute on ``cuda:0``)."""
    if device == "cpu":
        args, env = {"device": "cpu"}, {"OMP_NUM_THREADS": "1"}
    else:
        args, env = {"device": "cuda:0", "backend": "gloo"}, {}
    out = launch(n, "videocad_tpu_torch.parallel.dryrun:_dryrun_body",
                 args, timeout=timeout, env=env)[0]
    print(out, end="", flush=True)
    if "dryrun_multichip OK" not in out:
        raise RuntimeError(f"dryrun_multichip: no OK line:\n{out}")
    return out
