"""The PyTorch port's trainer, checkpoints, experiment and train CLI, held
against the JAX package's trainer where the two can be compared.

A tiny synthetic dataset (32 x 32 frames) is written once; the JAX trainer
and the port's run two epochs over it from the same weights (JAX's
``init_model``, carried over by ``state_dict_from_jax``) at float32 with
dropout off, and their epoch losses, metric counters and parameters are
compared. Resume, preemption, early stopping, the evaluation modes and the
first-mistake analysis are held by their properties and, for the analysis,
against the JAX host loop on random sequences.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.helpers import TINY_CONFIG
from tests.test_torch_port_train import _assert_trees_close
from videocad_tpu.data import dataset as jax_dataset
from videocad_tpu.data import pipeline as jax_pipeline
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.train import objective as jax_objective
from videocad_tpu.train.trainer import Trainer as JaxTrainer
from videocad_tpu_torch.cli import serve as port_serve
from videocad_tpu_torch.cli import train as port_cli
from videocad_tpu_torch.data.dataset import VideoCADDataset, load_split_ids
from videocad_tpu_torch.data.pipeline import DataPipeline
from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
from videocad_tpu_torch.experiment import (Experiment, default_loss_config,
                                           load_warm_start)
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train.checkpoint import CheckpointHandler
from videocad_tpu_torch.train.preempt import PreemptionGuard
from videocad_tpu_torch.train.trainer import Trainer, sequence_mistakes

CONFIG = dict(TINY_CONFIG, num_decoder_layers=1)       # depth 1 + 1
DROPOUT = dict(CONFIG, dropout=0.1, vit_attention_impl="fused",
               ln_impl="pallas", dropout_impl="pallas")
JAX_LOSS = jax_objective.LossConfig(jax_objective.REFERENCE_CMD_WEIGHTS)
PORT_LOSS = port_objective.LossConfig(port_objective.REFERENCE_CMD_WEIGHTS)
LR = 1e-3


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(root directory, store directory, the port's pipelines)."""
    root = str(tmp_path_factory.mktemp("torch_trainer"))
    store = os.path.join(root, "store")
    os.makedirs(store)
    write_synthetic_dataset(store, num_sequences=8, min_len=5, max_len=8,
                            image_size=32, seed=0, split_path=os.path.join(
                                store, "dataset_split.json"))
    return root, store, _pipes(store, VideoCADDataset, DataPipeline)


def _pipes(store, dataset_cls, pipeline_cls):
    splits = load_split_ids(os.path.join(store, "dataset_split.json"))
    return {split: pipeline_cls(dataset_cls(store, ids=splits[split]),
                                batch_size=2, buckets=(8,),
                                shuffle=split == "train", seed=0)
            for split in ("train", "val", "test")}


def _config(root, run, **overrides):
    return {"lr": LR, "save_frequency": 1, "val_frequency": 1,
            "experiment_name": "exp", "early_stopping_enabled": False,
            "checkpoint_dir": os.path.join(root, run, "ckpt"), **overrides}


def _trainer(env, run, model_config=CONFIG, train_pipe=None, model=None,
             **overrides):
    root, _, pipes = env
    if model is None:
        model = create_model(model_config,
                             generator=torch.Generator().manual_seed(0))
    return Trainer(model, train_pipe or pipes["train"], pipes["val"],
                   pipes["test"], _config(root, run, **overrides), PORT_LOSS,
                   log_dir=os.path.join(root, run, "logs"))


def _capture_epoch_losses(trainer):
    losses = []
    log_epoch = trainer._log_epoch

    def capture(epoch, epochs, avg_loss, metrics):
        losses.append(avg_loss)
        log_epoch(epoch, epochs, avg_loss, metrics)

    trainer._log_epoch = capture
    return losses


def _read(trainer, name):
    with open(os.path.join(trainer.logger.dir, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(env):
    """The JAX trainer and the port's after two epochs from one set of
    weights, with their epoch losses."""
    root, store, _ = env
    jax_model = jax_create_model(CONFIG)
    params = init_model(jax_model, jax.random.PRNGKey(0), batch=1, seq_len=2)
    model = create_model(CONFIG)
    model.load_state_dict(state_dict_from_jax(params))
    jax_pipes = _pipes(store, jax_dataset.VideoCADDataset,
                       jax_pipeline.DataPipeline)
    jax_trainer = JaxTrainer(
        jax_model, jax_pipes["train"], jax_pipes["val"], jax_pipes["test"],
        _config(root, "jax"), JAX_LOSS, params=params,
        log_dir=os.path.join(root, "jax", "logs"))
    port_trainer = _trainer(env, "port", model=model)
    jax_losses = _capture_epoch_losses(jax_trainer)
    port_losses = _capture_epoch_losses(port_trainer)
    jax_trainer.train(2)
    port_trainer.train(2)
    return jax_trainer, port_trainer, jax_losses, port_losses


def test_epoch_losses_match_the_jax_trainer(both):
    _, port_trainer, jax_losses, port_losses = both
    assert len(port_losses) == len(jax_losses) == 2
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    assert port_trainer.state.step == 2 * len(port_trainer.train_pipe) == 4


@pytest.mark.parametrize("name", ["epoch_1", "epoch_2", "val_epoch_1",
                                  "val_epoch_2"])
def test_metric_files_match_the_jax_trainer(both, name):
    jax_trainer, port_trainer, _, _ = both
    want, got = _read(jax_trainer, name), _read(port_trainer, name)
    assert set(got) == set(want)
    assert got["total_predictions"] > 0
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-6), key


def test_parameters_after_two_epochs_match_the_jax_trainer(both):
    jax_trainer, port_trainer, _, _ = both
    # lr 1e-3: a key bias may differ by up to lr in either package a step.
    _assert_trees_close(
        jax_tree_from_state_dict(port_trainer.model.state_dict()),
        jax_trainer.state.params, 1e-5, relative=False,
        key_bias_tol=2e-3 * port_trainer.state.step)


def test_evaluate_matches_the_jax_trainer_and_writes_its_file_names(both):
    jax_trainer, port_trainer, _, _ = both
    for kw, name in [({"mode": "test"}, "test"),
                     ({"mode": "val", "epoch": 4}, "val_epoch_5"),
                     ({"mode": "test", "ablation": True}, "test")]:
        want = jax_trainer.evaluate(**kw)
        got = port_trainer.evaluate(**kw)
        assert got == pytest.approx(want, rel=1e-6)
        assert _read(port_trainer, name) == pytest.approx(
            _read(jax_trainer, name), rel=1e-6)
    for kw, name in [({"mode": "test"}, "test_seq"),
                     ({"mode": "val", "ablation": True}, "val_seq")]:
        got = port_trainer.sequential_evaluate(**kw)
        assert got["total_predictions"] > 0
        assert set(_read(port_trainer, name)) == set(
            jax_trainer.sequential_evaluate(**kw))
        assert os.path.exists(os.path.join(jax_trainer.logger.dir,
                                           f"{name}.json"))


# ---- checkpoints ----

def _moments(state):
    return [(s["step"].clone(), s["exp_avg"].clone(), s["exp_avg_sq"].clone())
            for s in state.opt_state.state_dict()["state"].values()]


@pytest.mark.parametrize("freeze_cad,training_config", [
    (False, {"lr": LR}),
    (True, {"lr": LR}),                     # the cad group holds no moments
    (False, {"lr": LR, "frozen": True, "lr_cad": 1e-4, "lr_state": 3e-4}),
])
def test_checkpoint_round_trip(env, tmp_path, freeze_cad, training_config):
    """Parameters, both Adam moments, Adam's step counts, the step and the
    epoch come back, into an optimizer built by the same make_optimizer
    call."""
    _, _, pipes = env

    def make(seed):
        model = create_model(CONFIG,
                             generator=torch.Generator().manual_seed(seed))
        state = port_state.create_train_state(
            dict(model.named_parameters()), training_config, freeze_cad)
        return model, state

    model, state = make(1)
    step = port_trainer_step(model)
    batch = next(iter(pipes["train"].epoch(0)))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items() if k != "ids"}
    for _ in range(3):
        state, _, _ = step(state, tensors, 0)
    handler = CheckpointHandler("exp", str(tmp_path))
    path = handler.save(state, epoch=6, loss=1.25)
    assert path.endswith(os.path.join("exp", "epoch_7"))
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    assert handler.save(state, 6, 1.25, is_best=True).endswith("best_model")

    other_model, target = make(2)
    assert not torch.equal(other_model.predict_cmd.weight,
                           model.predict_cmd.weight)
    restored, meta = handler.restore("epoch_7", target)
    assert meta == {"epoch": 7, "loss": 1.25}
    assert restored.step == state.step == 3
    for name, param in model.named_parameters():
        assert param.dtype == torch.float32
        assert torch.equal(restored.params[name], param), name
    want, got = _moments(state), _moments(restored)
    assert len(got) == len(want) > 0
    frozen_out = sum(1 for n in state.params if "cad_encoder" in n)
    assert len(want) == len(state.params) - (frozen_out if freeze_cad else 0)
    for w, g in zip(want, got):
        assert float(g[0]) == float(w[0]) == 3
        assert torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])
    # One more step from either state lands on the same bits.
    state, loss, _ = step(state, tensors, 0)
    restored, other_loss, _ = port_trainer_step(other_model)(restored,
                                                             tensors, 0)
    assert float(loss) == float(other_loss)
    for name, param in model.named_parameters():
        assert torch.equal(restored.params[name], param), name


def port_trainer_step(model):
    from videocad_tpu_torch.train.steps import make_train_step
    return make_train_step(model, PORT_LOSS)


def test_restore_refuses_another_model_and_another_optimizer(env, tmp_path):
    model = create_model(CONFIG)
    state = port_state.create_train_state(dict(model.named_parameters()),
                                          {"lr": LR})
    handler = CheckpointHandler("exp", str(tmp_path))
    handler.save(state, 0, 0.0)
    wider = create_model(dict(CONFIG, enable_past_actions=False))
    with pytest.raises(ValueError, match="other parameters"):
        handler.restore("epoch_1", port_state.create_train_state(
            dict(wider.named_parameters()), {"lr": LR}))
    frozen = port_state.create_train_state(dict(model.named_parameters()),
                                           {"lr": LR}, freeze_cad=True)
    with pytest.raises(ValueError):       # Adam: another number of groups
        handler.restore("epoch_1", frozen)


def test_latest_epoch_ignores_litter(tmp_path):
    handler = CheckpointHandler("exp", str(tmp_path))
    assert handler.latest_epoch() is None
    for name in ["epoch_2", "epoch_10", "epoch_11.tmp-4242", "epoch_final",
                 "best_model", "epoch_"]:
        os.makedirs(os.path.join(handler.base, name))
    assert handler.latest_epoch() == "epoch_10"
    handler.wait()


def test_two_epochs_equal_one_epoch_resume_one_epoch_bit_for_bit(env):
    """With dropout, action noise and both "pallas" settings on: every
    random draw is a function of (seed, step), and the checkpoint carries
    the step."""
    straight = _trainer(env, "straight", DROPOUT, noise=True)
    straight.train(2)
    first = _trainer(env, "resumed", DROPOUT, noise=True)
    first.train(1)
    second = _trainer(env, "resumed", DROPOUT, noise=True)
    assert second.resume() is True
    assert second.start_epoch == 1 and second.state.step == 2
    second.train(2)
    assert second.state.step == straight.state.step == 4
    for name, param in straight.model.named_parameters():
        assert torch.equal(second.state.params[name], param), name
    assert _read(second, "epoch_2") == _read(straight, "epoch_2")
    fresh = _trainer(env, "nothing_to_resume")
    assert fresh.resume() is False and fresh.start_epoch == 0


# ---- preemption ----

class _SignalingPipeline:
    """Sends SIGTERM to this process after yielding ``kill_after`` batches
    of epoch ``kill_epoch``."""

    def __init__(self, inner, kill_epoch, kill_after):
        self.inner, self.kill_epoch, self.kill_after = (inner, kill_epoch,
                                                        kill_after)

    def __len__(self):
        return len(self.inner)

    def epoch(self, epoch):
        for i, batch in enumerate(self.inner.epoch(epoch)):
            yield batch
            if epoch == self.kill_epoch and i + 1 == self.kill_after:
                os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_mid_epoch_saves_and_resume_restarts_that_epoch(env):
    _, _, pipes = env
    prev = signal.getsignal(signal.SIGTERM)
    pipe = _SignalingPipeline(pipes["train"], kill_epoch=1, kill_after=1)
    kw = dict(save_frequency=100, val_frequency=100, log_frequency=1)
    trainer = _trainer(env, "preempt", train_pipe=pipe, **kw)
    trainer.train(epochs=50)
    # Stopped during the second epoch, far short of 50.
    assert trainer.checkpoints.latest_epoch() == "epoch_1"
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not os.path.exists(os.path.join(trainer.logger.dir,
                                           "epoch_3.json"))
    resumed = _trainer(env, "preempt", **kw)
    assert resumed.resume() is True
    assert resumed.start_epoch == 1
    resumed.train(epochs=3)
    assert os.path.exists(os.path.join(resumed.logger.dir, "epoch_3.json"))


def test_preemption_safe_off_leaves_signals_alone(env):
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda *a: calls.append(a))
    try:
        _trainer(env, "no_guard", preemption_safe=False).train(epochs=1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert len(calls) == 1    # our handler stayed installed throughout
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_guard_consensus_is_the_local_flag():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        assert guard.consensus() is False
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.signaled is True and guard.consensus() is True
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---- early stopping ----

@pytest.mark.parametrize("metric,mode,stops_after", [
    ("loss", "min", 3),          # an unreachable min_delta: never improves
    ("accuracy", "max", 3),
    ("loss", "max", 3),
])
def test_early_stopping_stops_when_nothing_improves(env, metric, mode,
                                                    stops_after):
    trainer = _trainer(
        env, f"es_{metric}_{mode}", early_stopping_enabled=True,
        early_stopping_metric=metric, early_stopping_mode=mode,
        early_stopping_patience=2, early_stopping_min_delta=1e9,
        save_frequency=100)
    trainer.train(epochs=20)
    # Epoch 1 improves on the initial best; two epochs without improvement
    # follow, then it stops and reloads the best weights.
    assert os.path.exists(os.path.join(trainer.logger.dir,
                                       f"epoch_{stops_after}.json"))
    assert not os.path.exists(os.path.join(
        trainer.logger.dir, f"epoch_{stops_after + 1}.json"))
    assert os.path.isdir(os.path.join(trainer.checkpoints.base, "best_model"))


def test_early_stopping_accuracy_is_not_poisoned_by_the_loss(env):
    trainer = _trainer(env, "es_none", early_stopping_enabled=True,
                       early_stopping_metric="accuracy", val_frequency=100)
    assert trainer._current_metric(3.5, None) is None
    assert trainer._current_metric(3.5, {"correct_predictions": 3.0,
                                         "total_predictions": 4.0}) == 0.75
    trainer.es_metric = "loss"
    assert trainer._current_metric(3.5, None) == 3.5
    assert trainer._improved(1.0, 0.5) and not trainer._improved(0.5, 1.0)
    trainer.es_mode = "min"
    assert trainer._improved(0.5, 1.0) and not trainer._improved(1.0, 0.5)


def test_profiling_window_writes_a_trace(env):
    """An epoch shorter than the wait / warm-up / active schedule is traced
    whole."""
    trainer = _trainer(env, "profiled", enable_profiling=True,
                       save_frequency=100, val_frequency=100)
    trainer.train(epochs=1)
    trace = os.path.join(trainer.logger.dir, "profile_traces", "epoch0",
                         "trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


# ---- first-mistake analysis ----

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 4), st.integers(1, 12),
       st.integers(0, 5))
def test_sequence_mistakes_on_tensors_equals_the_jax_host_loop(seed, batch,
                                                               steps, tol):
    rng = np.random.default_rng(seed)
    gt_cmd = rng.integers(0, 5, (batch, steps))
    gt_params = rng.integers(-1, 1000, (batch, steps, 6))
    gt_params[rng.random((batch, steps, 6)) < 0.4] = -1
    for i in range(batch):               # a padded tail, possibly the whole
        n = int(rng.integers(0, steps + 1))
        gt_cmd[i, n:] = -1
        gt_params[i, n:] = -1
    # Predictions near the truth, so that every branch of the windows and
    # the tolerances is met.
    pred_cmd = np.where(rng.random((batch, steps)) < 0.7, gt_cmd,
                        rng.integers(0, 5, (batch, steps)))
    pred_params = gt_params + rng.choice(
        [0, 0, 0, 1, -1, 3, -4, 49, 50, 199, 200, 499, 500, -600],
        (batch, steps, 6))
    got = sequence_mistakes(*(torch.from_numpy(a) for a in (
        gt_cmd, gt_params, pred_cmd, pred_params)), tol)
    assert len(got) == batch
    for i in range(batch):
        want = JaxTrainer._sequence_mistakes(
            JaxTrainer, gt_cmd[i], gt_params[i], pred_cmd[i], pred_params[i],
            tol)
        assert got[i] == want


def test_find_first_mistake_and_sample(env, tmp_path):
    trainer = _trainer(env, "analysis")
    data = trainer.find_first_mistake(mode="test", tol=2)
    assert len(data) == 2
    n_test = 2 * len(trainer.test_pipe)
    for bucket in data:
        assert set(bucket) == {"First Mistakes", "Memory",
                               "Sequence Lengths", "Number of Mistakes"}
        assert len(bucket["Sequence Lengths"]) == n_test
        assert len(bucket["Number of Mistakes"]) == n_test
        assert sum(len(v) for v in bucket["First Mistakes"].values()) <= n_test
    out = str(tmp_path / "samples")
    trainer.sample(n=1, folder=out, mode="test")
    assert len(os.listdir(out)) == 3                  # stops at n samples
    trainer.sample(n=10, folder=out, mode="test")     # the split holds 2
    names = sorted(os.listdir(out))
    assert len(names) == 6
    assert sum(n.startswith("pred_actions_") for n in names) == 2
    assert sum(n.startswith("images_") and n.endswith(".png")
               for n in names) == 2
    sample_id = names[0].split("_")[-1].split(".")[0]
    with open(os.path.join(out, f"pred_actions_{sample_id}.csv")) as f:
        rows = [line.split(",") for line in f.read().split()]
    assert len(rows) == 7 and all(len(r) == 7 for r in rows)   # bucket 8 - 1


# ---- experiment, CLIs ----

def _argv(env, run, *extra):
    root, store, _ = env
    model_config = os.path.join(root, f"{run}_model.json")
    with open(model_config, "w") as f:
        json.dump({"tiny": dict(DROPOUT, train_config={
            "experiment_name": "cli", "save_frequency": 1,
            "val_frequency": 1, "seq_val_frequency": 1, "log_frequency": 1,
            "sequential": True})}, f)
    return ["--dataset_path", store,
            "--config_path", os.path.join(store, "dataset_split.json"),
            "--model_config", model_config, "--model_name", "tiny",
            "--batch_size", "2", "--buckets", "8", "--lr", "1e-3",
            "--checkpoint_dir", os.path.join(root, run, "ckpt"),
            "--log_dir", os.path.join(root, run, "logs"),
            "--class_weights", os.path.join(root, "none.json"), *extra]


def test_train_cli_runs_an_epoch_on_the_cpu_and_resumes(env):
    root = env[0]
    results = port_cli.main(_argv(env, "cli", "--device", "cpu",
                                  "--epochs", "1"))
    assert results["total_predictions"] > 0
    log_dir = os.path.join(root, "cli", "logs", "cli")
    # The file names of the JAX layout.
    assert sorted(os.listdir(log_dir)) == sorted([
        "params.json", "training_config.json", "results.json",
        "seq_results.json", "epoch_1.json", "val_epoch_1.json",
        "val_seq.json", "test.json", "test_seq.json"])
    with open(os.path.join(log_dir, "training_config.json")) as f:
        saved = json.load(f)
    assert saved["experiment_name"] == "cli" and saved["sequential"] is True
    ckpt = os.path.join(root, "cli", "ckpt", "cli")
    assert {"epoch_1", "best_model"} <= set(os.listdir(ckpt))
    port_cli.main(_argv(env, "cli", "--device", "cpu", "--epochs", "2",
                        "--resume"))
    assert os.path.exists(os.path.join(log_dir, "epoch_2.json"))
    with open(os.path.join(ckpt, "epoch_2", "meta.json")) as f:
        assert json.load(f)["epoch"] == 2

    # The serving CLI loads the trainer's checkpoint.
    with open(_argv(env, "cli")[5]) as f:
        params = json.load(f)["tiny"]
    args = port_serve.parse_args([
        "--device", "cpu", "--lanes", "2", "--seq_len", "8",
        "--model_config", _argv(env, "cli")[5], "--model_name", "tiny",
        "--checkpoint_folder", os.path.join(ckpt, "epoch_2")])
    engine = port_serve.build_engine(args)
    try:
        saved = torch.load(os.path.join(ckpt, "epoch_2", "state.pt"),
                           weights_only=True)["params"]
        for name, value in engine.model.state_dict().items():
            assert torch.equal(value, saved[name]), name
        assert engine.model.config.ln_impl == params["ln_impl"] == "pallas"
    finally:
        engine.stop()


def test_train_cli_refuses_cuda_without_a_card(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(_argv(env, "cli_cuda", "--epochs", "1"))  # the default
    assert port_cli.parse_args([]).device == "cuda"


@pytest.mark.parametrize("flags,item", [
    (["--data_parallel", "2"], "slice 9"),
    (["--model_parallel", "2"], "slice 9"),
    (["--dcn_slices", "2"], "slice 9"),
    (["--native_loader"], "slice 8"),
    (["--quant", "int8"], "slice 11"),
])
def test_train_cli_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(["--device", "cpu", *flags])
    with pytest.raises(SystemExit):          # no counterpart in the port
        port_cli.parse_args(["--dropout_rng_impl", "rbg"])


def _experiment(env, run):
    root, _, pipes = env
    return Experiment(
        pipes["train"], pipes["val"], pipes["test"],
        {"lr": LR, "epochs": 1, "save_frequency": 1, "val_frequency": 1,
         "early_stopping_enabled": False,
         "checkpoint_dir": os.path.join(root, run, "ckpt")},
        device="cpu", log_dir=os.path.join(root, run, "logs"),
        class_weights_path=None)


def test_experiment_grid_expands_list_params(env):
    root = env[0]
    results = _experiment(env, "grid").run_grid(dict(CONFIG,
                                                     window_size=[2, 3]))
    assert len(results) == 2
    runs = sorted(os.listdir(os.path.join(root, "grid", "logs")))
    assert len(runs) == 2
    windows = set()
    for run in runs:
        with open(os.path.join(root, "grid", "logs", run,
                               "params.json")) as f:
            windows.add(json.load(f)["window_size"])
        assert os.path.exists(os.path.join(root, "grid", "logs", run,
                                           "results.json"))
    assert windows == {2, 3}


def test_experiment_warm_starts(env, tmp_path):
    """From a checkpoint directory of the port and from JAX weights in a
    params.npz; a reference .pt is refused."""
    trained = _trainer(env, "warm_source")
    trained.train(1)
    ckpt = os.path.join(trained.checkpoints.base, "epoch_1")
    model = create_model(CONFIG, generator=torch.Generator().manual_seed(5))
    load_warm_start(model, ckpt)
    for name, param in trained.model.named_parameters():
        assert torch.equal(dict(model.named_parameters())[name], param)

    from videocad_tpu.infer.export import _flatten_params
    jax_model = jax_create_model(CONFIG)
    params = init_model(jax_model, jax.random.PRNGKey(3), batch=1, seq_len=2)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **{k: np.asarray(v)
                     for k, v in _flatten_params(params).items()})
    load_warm_start(model, npz)
    want = state_dict_from_jax(params)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name

    with pytest.raises(NotImplementedError, match="slice 0"):
        load_warm_start(model, "reference.pt")
    with pytest.raises(FileNotFoundError):
        load_warm_start(model, str(tmp_path / "exp" / "epoch_9"))
    results = _experiment(env, "warm").run_with_config(
        {"tiny": dict(CONFIG, state_dict=ckpt)}, "tiny")
    assert results["total_predictions"] > 0


def test_default_loss_config_reads_class_weights(tmp_path):
    assert default_loss_config({}).cmd_weights == \
        port_objective.REFERENCE_CMD_WEIGHTS
    assert default_loss_config({"use_mse": False}).use_mse is False
    path = str(tmp_path / "class_weights.json")
    with open(path, "w") as f:
        json.dump({"Label": [0.1, 0.2, 0.3, 0.2, 0.2]}, f)
    assert default_loss_config({}, path).cmd_weights == (0.1, 0.2, 0.3, 0.2,
                                                         0.2)
