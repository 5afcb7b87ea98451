"""The port's parallel layer against the JAX package's single-device step.

The ranks are processes over gloo, started by
``videocad_tpu_torch.parallel.dryrun.launch``, which import no jax
(``tests/torch_parallel_worker.py``). Each group runs one mesh: data 2,
model 2, data 2 x model 2, and dcn 2 x data 1 x model 1. Its steps take
the rows of one global batch (B = 4) and are held, after 1 and 3 steps, to
the JAX single-device step on the whole batch from the same weights: the
loss and the counters summed over the data ranks, and the parameters
gathered from the shards. The tiny config, float32, dropout 0; the JAX
ViT attention runs in Pallas interpret mode, the port's through the K1
kernel's plain version (1 head of 8 a model rank). Tolerances as in
``tests/test_torch_port_train.py``: the loss 1e-4 relative, the attention
key biases (noise gradients) 2e-3 a step, the counters exactly; the other
parameters 2e-5 absolute. On this batch the single-process port is 1.18e-5
from JAX at one entry of ``embed_image`` after the first step (Adam's
first update is about lr times the sign of the gradient, so an entry whose
gradient is near rounding moves by a rounding-dependent share of lr = 1e-3):
``test_single_process_step_is_within_the_same_bound`` holds the one
process to the bound that the meshes are held to.

One case has bin class weights (``use_mse: false``) whose sums differ
between the two data ranks' rows: there the mean of the ranks' losses,
which DDP's averaging would give, misses the JAX loss.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.train import objective as jax_objective
from videocad_tpu.train import state as jax_state
from videocad_tpu.train import steps as jax_steps
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.parallel.dryrun import launch
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train.checkpoint import CheckpointHandler
from videocad_tpu_torch.train.steps import make_train_step, prepare_model_inputs

CONFIG = dict(TINY_CONFIG, vit_attention_impl="fused")
STEPS = 3
BATCH = 4
PARAM_TOL = 2e-5


def _bin_weights():
    rng = np.random.default_rng(5)
    data = {"Label": list(jax_objective.REFERENCE_CMD_WEIGHTS)}
    for name in ("x", "y", "Key Pressed", "Scroll"):
        data[name] = [float(v) for v in rng.random(1000) * 4 + 0.1]
    return data


def _loss_configs(name):
    """(JAX, port) loss configs: "mse" the default tolerance CE, "bins"
    the 1000-bin class-weighted CE of ``use_mse: false``."""
    if name == "mse":
        kw = dict(cmd_weights=jax_objective.REFERENCE_CMD_WEIGHTS,
                  use_mse=True)
        return (jax_objective.LossConfig(**kw),
                port_objective.LossConfig(**kw))
    data = _bin_weights()
    return (jax_objective.LossConfig.from_class_weights(data, use_mse=False),
            port_objective.LossConfig.from_class_weights(data,
                                                         use_mse=False))


def _global_batch(name):
    data = port_synthetic.synthetic_batch_feed(BATCH, 8, image_size=32,
                                               seed=11)
    if name == "bins":
        # Rank 0's rows take few labelled steps, rank 1's many: the ranks'
        # weight sums differ.
        data["actions"][:2, 3:, 1:] = -1
    return data


def _is_key_bias(path) -> bool:
    names = [getattr(p, "key", None) for p in path]
    return names[-2:] == ["key", "bias"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX single-device run of each loss setting (losses, counters,
    parameters after step 1 and 3), and the spec files of the meshes."""
    root = tmp_path_factory.mktemp("parallel")
    jax_model = jax_create_model(CONFIG)
    params = init_model(jax_model, jax.random.PRNGKey(0), batch=1,
                        seq_len=2)
    state_dict = {k: v.clone() for k, v in state_dict_from_jax(params).items()}
    runs, jobs = {}, []
    for name in ("mse", "bins"):
        jax_loss, port_loss = _loss_configs(name)
        st, tx = jax_state.create_train_state(params, {"lr": 1e-3})
        step = jax.jit(jax_steps.make_train_step(jax_model, tx, jax_loss))
        batch = _global_batch(name)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        losses, metrics, trees = [], [], {}
        for i in range(STEPS):
            st, loss, m = step(st, jbatch, jax.random.PRNGKey(0))
            losses.append(float(loss))
            metrics.append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, STEPS):
                trees[i + 1] = jax.device_get(st.params)
        runs[name] = dict(loss=losses, metrics=metrics, params=trees,
                          port_loss=port_loss, batch=batch)
        jobs.append(dict(name=name, state_dict=state_dict, batch=batch,
                         steps=STEPS,
                         loss_config=dict(
                             cmd_weights=port_loss.cmd_weights,
                             use_mse=port_loss.use_mse,
                             param_bin_weights=port_loss.param_bin_weights)))
    return root, runs, jobs, state_dict


def _run(reference, shape, jobs, **extra):
    root, _, all_jobs, _ = reference
    tag = "_".join(f"{k}{v}" for k, v in shape.items())
    spec = dict(mesh=shape, config=json.dumps(CONFIG),
                jobs=[j for j in all_jobs if j["name"] in jobs], **extra)
    spec_path, out_path = str(root / f"{tag}.pt"), str(root / f"{tag}.out")
    torch.save(spec, spec_path)
    world = int(np.prod(list(shape.values())))
    launch(world, "tests.torch_parallel_worker:parity",
           {"spec": spec_path, "out_path": out_path}, timeout=300,
           env={"OMP_NUM_THREADS": "1"})
    return torch.load(out_path, weights_only=False)


def _assert_close_to_jax(record, run, steps_checked=(1, STEPS)):
    for i in range(STEPS):
        np.testing.assert_allclose(record["loss"][i], run["loss"][i],
                                   rtol=1e-4)
        for key, want in run["metrics"][i].items():
            assert record["metrics"][i][key] == want, (i, key)
    for steps in steps_checked:
        got = dict(jax.tree_util.tree_leaves_with_path(
            jax_tree_from_state_dict(record["params"][steps])))
        want = dict(jax.tree_util.tree_leaves_with_path(run["params"][steps]))
        assert sorted(map(str, got)) == sorted(map(str, want))
        for path, w in want.items():
            tol = 2e-3 * steps if _is_key_bias(path) else PARAM_TOL
            np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                       atol=tol, rtol=0, err_msg=str(path))
    assert np.isfinite(record["eval_loss"]) and record["eval_total"] > 0


def test_data_parallel_steps_equal_the_jax_step_with_unequal_weight_sums(
        reference):
    """data = 2: the plain batch and the bin-weighted one, whose mean of
    per-rank losses misses the global loss that the port computes."""
    _, runs, _, state_dict = reference
    out = _run(reference, {"data": 2, "model": 1}, ["mse", "bins"],
               consensus=True)
    for name in ("mse", "bins"):
        _assert_close_to_jax(out[name], runs[name])
        assert all(not spec for spec in out[name]["layout"].values())
    # What an average of the ranks' means would give, one process.
    run = runs["bins"]
    model = create_model(CONFIG)
    model.load_state_dict(state_dict)
    halves, sums = [], []
    for rows in (slice(0, 2), slice(2, 4)):
        batch = {k: torch.from_numpy(v[rows]) for k, v in run["batch"].items()}
        inputs, targets = prepare_model_inputs(batch)
        loss, _ = port_objective.compute_loss_and_metrics(
            *model(inputs), targets, run["port_loss"])
        halves.append(loss.item())
        sums.append(int((targets[..., 1:] != -1).sum()))
    assert sums[0] != sums[1]
    assert abs(np.mean(halves) - run["loss"][0]) > 1e-2 * run["loss"][0]
    # The stop flag: one signaled rank stops both.
    assert out["consensus"] == {"before": False, "after": True,
                                "signaled_ranks": 1.0}


def test_model_parallel_steps_and_checkpoints(reference, tmp_path):
    """model = 2: the split layout, the steps against JAX, a checkpoint
    written under the mesh that loads in one process, and one process's
    checkpoint restored into the shards."""
    _, runs, _, state_dict = reference
    ckpt = str(tmp_path)
    single = create_model(CONFIG)
    single.load_state_dict(state_dict)
    single_state = port_state.create_train_state(
        dict(single.named_parameters()), {"lr": 1e-3})
    for p in single_state.params.values():
        p.grad = torch.full_like(p, 0.01)
    single_state = single_state.apply_gradients()
    CheckpointHandler("single", ckpt).save(single_state, 0, 1.0)

    out = _run(reference, {"data": 1, "model": 2}, ["mse"], checkpoint=ckpt)
    record = out["mse"]
    _assert_close_to_jax(record, runs["mse"])
    layout = record["layout"]
    assert layout["decoder.layers_0.self_attn.query.weight"] == ("model",
                                                                None)
    assert layout["decoder.layers_0.linear2.weight"] == (None, "model")
    assert layout["predict_params.bias"] == ("model",)
    assert layout["state_encoder.block_0.attn.out.bias"] == ()
    assert record["replicated_equal"]
    # The mesh's checkpoint, in one process: the gathered parameters and
    # full-size moments.
    fresh = create_model(CONFIG)
    target = port_state.create_train_state(dict(fresh.named_parameters()),
                                           {"lr": 1e-3})
    restored, meta = CheckpointHandler("mesh", ckpt).restore("epoch_1",
                                                             target)
    assert meta["epoch"] == 1 and restored.step == STEPS
    for k, p in restored.params.items():
        assert torch.equal(p.detach(), record["params"][STEPS][k]), k
    moments = restored.opt_state.state_dict()["state"]
    assert [tuple(m["exp_avg"].shape) for m in moments.values()] == [
        tuple(p.shape) for g in restored.opt_state.param_groups
        for p in g["params"]]
    # One process's checkpoint, restored into the shards and gathered.
    back = out["restored"]
    assert back["step"] == 1 and back["epoch"] == 1
    for k, p in single_state.params.items():
        assert torch.equal(back["params"][k], p.detach()), k
    assert any(len(s) == 2 and s[0] != tuple(single_state.params[
        "predict_params.weight"].shape)[0] for s in back["exp_avg_shapes"])


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2},
                                   {"dcn": 2, "data": 1, "model": 1}],
                         ids=["data2_model2", "dcn2"])
def test_mesh_steps_equal_the_jax_step(reference, shape):
    _, runs, _, _ = reference
    out = _run(reference, shape, ["mse"])
    _assert_close_to_jax(out["mse"], runs["mse"])
    assert out["mse"]["replicated_equal"]


def test_single_process_step_is_within_the_same_bound(reference):
    """The one-process port on the same batches and weights, held to the
    bounds of the meshes."""
    _, runs, _, state_dict = reference
    for name, run in runs.items():
        model = create_model(CONFIG)
        model.load_state_dict(state_dict)
        state = port_state.create_train_state(
            dict(model.named_parameters()), {"lr": 1e-3})
        step = make_train_step(model, run["port_loss"])
        batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
        record = {"loss": [], "metrics": [], "params": {},
                  "eval_loss": 0.0, "eval_total": 1.0}
        for i in range(STEPS):
            state, loss, metrics = step(state, batch, 0)
            record["loss"].append(float(loss))
            record["metrics"].append({k: float(v)
                                      for k, v in metrics.items()})
            if i + 1 in (1, STEPS):
                record["params"][i + 1] = {
                    k: p.detach().clone() for k, p in state.params.items()}
        _assert_close_to_jax(record, run)
