"""The port's parallel layer: its rule table and rank grids against the
JAX package's, and the multi-rank entry points on the CPU over gloo
(``cli.train.main --data_parallel 2`` with ``--resume``, and
``dryrun_multichip(4, "cpu")``). The ranks are processes that import no
jax (``videocad_tpu_torch.parallel.dryrun.launch``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.parallel import mesh as jax_mesh
from videocad_tpu.parallel import sharding as jax_sharding
from videocad_tpu_torch.cli import train as port_cli
from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
from videocad_tpu_torch.models import create_model
from videocad_tpu_torch.models.convert import flat_jax_params
from videocad_tpu_torch.models.factory import flagship_config
from videocad_tpu_torch.parallel import mesh as port_mesh
from videocad_tpu_torch.parallel import sharding as port_sharding
from videocad_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from videocad_tpu_torch.train.checkpoint import CheckpointHandler

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "model_configs")
# Widths cut, depths kept: the names are those of the full model.
CUT = dict(image_size=32, vit_patch=16, vit_dim=32, vit_heads=2,
           vit_head_dim=16, vit_mlp_dim=32, hidden_size=32,
           dim_feedforward=32, dtype="float32")


def _named_configs():
    cases = [("flagship", flagship_config())]
    for fname in sorted(os.listdir(CONFIG_DIR)):
        if fname.endswith(".json"):
            with open(os.path.join(CONFIG_DIR, fname)) as f:
                for name, cfg in json.load(f).items():
                    cases.append((f"{fname}:{name}", cfg))
    return cases


def test_param_pspec_is_the_jax_rule_table_on_every_named_config():
    """For every parameter of the flagship and of every named config: the
    port's spec is the JAX spec of the same leaf, in the torch layout (a
    2-D ``weight`` is the transposed ``kernel``)."""
    seen = set()
    for label, cfg in _named_configs():
        cut = dict(cfg, **CUT)
        if cut.get("use_pretrained_cad_model"):
            cut["vit_patch"] = 32
        model = create_model(cut)
        for name, p in model.named_parameters():
            (jax_name,) = flat_jax_params({name: p}).keys()
            want = tuple(jax_sharding.param_pspec(tuple(jax_name.split("/"))))
            want = want + (None,) * (p.dim() - len(want))
            if p.dim() == 2 and jax_name.endswith("kernel"):
                want = want[::-1]
            got = port_sharding.param_pspec(name)
            got = got + (None,) * (p.dim() - len(got))
            assert got == want, (label, name, got, want)
            seen.add(got)
    assert {("model", None), (None, "model"), ("model",)} <= seen


@pytest.mark.parametrize("model_size", [2, 3])
def test_shard_model_lays_out_the_rule_table(model_size):
    """The layout ``shard_model`` makes is the rule table's wherever a
    unit divides, and replicated where it does not: at model 2 every
    parameter of every named config follows the table; at model 3 the
    ViT's 2 heads and 32-wide MLP stay whole, and the parameter head's
    6,000 columns split."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(model_size=model_size, model_rank=0,
                           model_group=None)
    for label, cfg in _named_configs():
        cut = dict(cfg, **CUT)
        if cut.get("use_pretrained_cad_model"):
            cut["vit_patch"] = 32
        model = create_model(cut)
        full = {k: tuple(p.shape) for k, p in model.named_parameters()}
        layout = port_sharding.shard_model(model, mesh)
        for name, p in model.named_parameters():
            table = port_sharding.param_pspec(name)
            if model_size == 2 or name.startswith("predict_params"):
                assert layout[name] == table, (label, name)
            elif "encoder" in name:
                assert layout[name] == (), (label, name)
            want = [n // model_size if axis else n for n, axis in
                    zip(full[name], layout[name] or (None,) * p.dim())]
            assert list(p.shape) == want, (label, name)


@pytest.mark.parametrize("n,shape", [
    (4, dict(data=2, model=2)), (4, dict(data=None, model=2)),
    (8, dict(data=4, model=2)), (4, dict(data=4, model=1)),
    (4, dict(dcn=2, data=1, model=2)), (8, dict(dcn=2, data=None, model=2)),
    (2, dict(dcn=2, data=1, model=1))])
def test_rank_grids_equal_jax_device_grids(n, shape):
    devices = jax.devices()[:n]
    if "dcn" in shape:
        want = jax_mesh.create_hybrid_mesh(shape["dcn"], shape["data"],
                                           shape["model"], devices=devices)
        got = port_mesh.mesh_grid(n, shape["data"], shape["model"],
                                  shape["dcn"])
    else:
        want = jax_mesh.create_mesh(shape["data"], shape["model"],
                                    devices=devices)
        got = port_mesh.mesh_grid(n, shape["data"], shape["model"])
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got, ids)
    assert got.shape == want.devices.shape


def test_a_mesh_that_disagrees_with_the_world_names_both_numbers():
    with pytest.raises(ValueError, match="needs 6 ranks.*world has 4"):
        port_mesh.mesh_grid(4, 3, 2)
    with pytest.raises(ValueError, match="4 ranks do not divide by model=3"):
        port_mesh.mesh_grid(4, None, 3)
    mesh = port_mesh.Mesh(("data", "model"), port_mesh.mesh_grid(4, 2, 2), 3)
    assert (mesh.data_rank, mesh.model_rank, mesh.rows(8)) == (
        1, 1, slice(4, 8))
    with pytest.raises(ValueError, match="batch size 5 does not divide"):
        mesh.rows(5)


def test_ranks_take_their_grid_places_and_rows(tmp_path):
    """Four ranks build (data 2, model 2) and (dcn 2, data 1, model 2):
    each sits where JAX puts its device, and data rank r holds rows
    [r * B / dp, (r + 1) * B / dp)."""
    out = str(tmp_path / "grid.npy")
    shapes = [dict(data=2, model=2), dict(dcn=2, data=1, model=2)]
    launch(4, "tests.torch_parallel_worker:grid",
           {"out_path": out, "shapes": shapes}, timeout=120,
           env={"OMP_NUM_THREADS": "1"})
    for table in np.load(out):
        np.testing.assert_array_equal(table, [[0, 0, 0, 0], [1, 0, 1, 0],
                                              [2, 1, 0, 4], [3, 1, 1, 4]])


def _store(root):
    store = os.path.join(root, "store")
    os.makedirs(store)
    write_synthetic_dataset(store, num_sequences=12, min_len=5, max_len=8,
                            image_size=32, seed=0, split_path=os.path.join(
                                store, "dataset_split.json"))
    with open(os.path.join(root, "model.json"), "w") as f:
        json.dump({"tiny": dict(TINY_CONFIG, train_config={
            "experiment_name": "cli", "save_frequency": 1,
            "val_frequency": 1, "seq_val_frequency": 1, "log_frequency": 1,
            "sequential": True, "early_stopping_enabled": False})}, f)
    return store


def _argv(root, store, run, *extra):
    return ["--device", "cpu", "--dataset_path", store,
            "--config_path", os.path.join(store, "dataset_split.json"),
            "--model_config", os.path.join(root, "model.json"),
            "--model_name", "tiny", "--batch_size", "2", "--buckets", "8",
            "--lr", "1e-3", "--no_enable_random",
            "--checkpoint_dir", os.path.join(root, run, "ckpt"),
            "--log_dir", os.path.join(root, run, "logs"),
            "--class_weights", os.path.join(root, "none.json"), *extra]


def test_train_cli_on_two_data_ranks_equals_one_process_and_resumes(
        tmp_path):
    """``cli.train.main --data_parallel 2`` on two gloo ranks: the rows of
    each global batch of two split over the ranks; the test counters and
    the checkpoint equal one process's (the counters exactly, the
    parameters within 2e-5, as ``tests/test_torch_port_parallel.py``
    holds them); only rank 0 writes the logs; ``--resume`` continues from
    the epoch-1 checkpoint."""
    root = str(tmp_path)
    store = _store(root)
    single = port_cli.main(_argv(root, store, "one", "--epochs", "1"))
    launch(2, "videocad_tpu_torch.cli.train:main",
           {"argv": _argv(root, store, "two", "--epochs", "1",
                          "--data_parallel", "2")},
           timeout=300, env={"OMP_NUM_THREADS": "1"})
    with open(os.path.join(root, "two", "logs", "cli", "results.json")) as f:
        results = json.load(f)
    for key in ("total_predictions", "correct_predictions",
                "cmd_counts_0", "param_counts_0"):
        assert results[key] == single[key], key
    assert results["total_predictions"] > 0
    one = CheckpointHandler("cli", os.path.join(root, "one", "ckpt"))
    two = CheckpointHandler("cli", os.path.join(root, "two", "ckpt"))
    assert one.latest_epoch() == two.latest_epoch() == "epoch_1"
    a = torch.load(os.path.join(one.base, "epoch_1", "state.pt"))
    b = torch.load(os.path.join(two.base, "epoch_1", "state.pt"))
    assert a["step"] == b["step"] > 1
    for k, v in a["params"].items():
        tol = 2e-3 * a["step"] if k.endswith("key.bias") else 2e-5
        np.testing.assert_allclose(b["params"][k].numpy(), v.numpy(),
                                   atol=tol, rtol=0, err_msg=k)
    texts = launch(2, "videocad_tpu_torch.cli.train:main",
                   {"argv": _argv(root, store, "two", "--epochs", "2",
                                  "--data_parallel", "2", "--resume")},
                   timeout=300, env={"OMP_NUM_THREADS": "1"})
    assert "Resumed from epoch_1 at epoch 1" in texts[0]
    assert "Epoch" in texts[0] and "Epoch" not in texts[1]  # rank 0 logs
    assert two.latest_epoch() == "epoch_2"


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    out = dryrun_multichip(4, "cpu", timeout=300)
    for line in ("dryrun train step OK", "dryrun eval step OK",
                 "dryrun rollout OK", "checkpoint resume OK",
                 "dryrun_multichip OK: 4 ranks (data=2, model=2)"):
        assert line in out
