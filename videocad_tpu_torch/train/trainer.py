"""Training and evaluation orchestration.

Port of ``videocad_tpu/train/trainer.py`` around the port's train and eval
steps: the epoch loop with per-epoch reshuffling, validation cadence, early
stopping (loss or accuracy, min or max, patience, min_delta), JSON metric
snapshots in the ``logs/<experiment>/`` layout, checkpoints with true
resume, an optional ``torch.profiler`` window, and the evaluation suite:
teacher-forced ``evaluate``, KV-cached ``sequential_evaluate``, per-sample
CSV dumps and first-mistake analysis.

The model's parameters are the state (``train/state.py``), so where the JAX
trainer takes ``params`` a caller loads them into the model beforehand.

With a ``mesh`` (``parallel/mesh.py``) every rank runs a trainer: the model
is split over the model axis, the steps run under DDP over the data group,
each rank's pipelines yield its rows of every global batch, and only rank
0 logs, writes metrics and saves (checkpoints gather the shards first).
The loss and the counters are summed over the data group in the one fetch
of each ``log_frequency`` interval, so the loop adds no host
synchronisation; ``evaluate`` and ``sequential_evaluate`` sum each rank's
counters once at the end.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from videocad_tpu_torch.actions.ops import apply_action_mask
from videocad_tpu_torch.data.pipeline import device_prefetch
from videocad_tpu_torch.infer.rollout import sequential_inference
from videocad_tpu_torch.parallel.collectives import all_reduce
from videocad_tpu_torch.parallel.sharding import shard_model
from videocad_tpu_torch.train.checkpoint import CheckpointHandler
from videocad_tpu_torch.train.metrics import init_metrics, update_metrics
from videocad_tpu_torch.train.objective import (LossConfig,
                                                compute_loss_and_metrics)
from videocad_tpu_torch.train.preempt import PreemptionGuard
from videocad_tpu_torch.train.state import create_sharded_train_state
from videocad_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                            prepare_model_inputs)
from videocad_tpu_torch.utils import trace


def _array_batch(batch: Dict) -> Dict:
    """The arrays of a host batch, kept as numpy (strings dropped)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


class MetricsLogger:
    """JSON snapshots under logs/<experiment>/."""

    def __init__(self, experiment_name: str, log_dir: str = "logs",
                 enabled: bool = True):
        self.dir = os.path.join(log_dir, experiment_name)
        self.enabled = enabled
        os.makedirs(self.dir, exist_ok=True)

    def save(self, metrics: Dict, ext: str):
        if not self.enabled:
            return
        with open(os.path.join(self.dir, f"{ext}.json"), "w") as f:
            json.dump({k: float(v) if isinstance(v, (int, float, np.floating))
                       else v for k, v in metrics.items()}, f, indent=4)


def _init_mistake_bucket() -> Dict:
    return {
        "First Mistakes": {f"cmd_{i}": [] for i in range(5)}
        | {f"param_{i}": [] for i in range(6)},
        "Memory": {"cmd": [], **{f"param_{i}": [] for i in range(6)}},
        "Sequence Lengths": [],
        "Number of Mistakes": [],
    }


def _param_errors(diff: torch.Tensor, tolerance: int) -> torch.Tensor:
    """(..., 6) bool: two-sided tolerance for x, y and typed value,
    one-sided windows for key, times and scroll."""
    two_sided = diff.abs() > tolerance
    windows = diff.new_tensor([0, 0, 50, 200, 500, 0])
    one_sided = (diff < 0) | (diff >= windows)
    pick = torch.tensor([True, True, False, False, False, True],
                        device=diff.device)
    return torch.where(pick, two_sided, one_sided)


def sequence_mistakes(gt_cmd: torch.Tensor, gt_params: torch.Tensor,
                      pred_cmd: torch.Tensor, pred_params: torch.Tensor,
                      tolerance: int) -> List[Dict]:
    """First-error analysis of a batch of sequences, one bucket each.

    gt_cmd, pred_cmd: (B, T) int; gt_params, pred_params: (B, T, 6) int;
    the padded tail (gt_cmd == -1) is excluded. Per sequence: the first
    mistaken field (the command before the parameters, in index order) as
    ``First Mistakes``, the (gt, pred) pairs per field as ``Memory``,
    ``[step of the first mistake, length]`` as ``Sequence Lengths``, and
    the per-step mistake flags. The comparisons, the per-step flags and the
    search for the first mistake run as tensor ops over the whole batch;
    only the lists of the result are assembled on the host.
    """
    steps = gt_cmd.shape[1]
    lengths = (gt_cmd != -1).sum(dim=1)
    in_seq = (torch.arange(steps, device=gt_cmd.device)[None, :]
              < lengths[:, None])
    labeled = (gt_params != -1) & in_seq[..., None]
    cmd_err = (gt_cmd != pred_cmd) & in_seq
    param_err = _param_errors(pred_params - gt_params, tolerance) & labeled
    field_err = torch.cat([cmd_err[..., None], param_err], dim=-1)  # (B,T,7)
    step_err = field_err.any(dim=-1)
    flat = field_err.flatten(1).to(torch.uint8)
    first = flat.argmax(dim=1)          # the first set entry, 0 when none
    has_mistake = flat.any(dim=1)

    (lengths, labeled, step_err, first, has_mistake, gt_cmd, gt_params,
     pred_cmd, pred_params) = (
        x.cpu().numpy() for x in (lengths, labeled, step_err, first,
                                  has_mistake, gt_cmd, gt_params, pred_cmd,
                                  pred_params))
    out = []
    for i in range(gt_cmd.shape[0]):
        seq = _init_mistake_bucket()
        n = int(lengths[i])
        seq["Memory"]["cmd"] = np.stack(
            [gt_cmd[i, :n], pred_cmd[i, :n]], axis=1).tolist()
        for k in range(gt_params.shape[-1]):
            rows = labeled[i, :, k]
            seq["Memory"][f"param_{k}"] = np.stack(
                [gt_params[i, rows, k], pred_params[i, rows, k]],
                axis=1).tolist()
        if has_mistake[i]:
            j, field = divmod(int(first[i]), 7)
            if field == 0:
                seq["First Mistakes"][f"cmd_{int(gt_cmd[i, j])}"].append(
                    f"cmd_{int(pred_cmd[i, j])}")
            else:
                seq["First Mistakes"][f"param_{field - 1}"].append(
                    f"param_{int(pred_params[i, j, field - 1])}")
            seq["Sequence Lengths"] = [j, n]
        else:
            seq["Sequence Lengths"] = [n, n]
        seq["Number of Mistakes"] = step_err[i, :n].astype(int).tolist()
        out.append(seq)
    return out


class Trainer:
    def __init__(self, model, train_pipe, val_pipe, test_pipe,
                 training_config: Dict, loss_config: LossConfig,
                 log_dir: str = "logs", mesh=None):
        self.model = model
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0
        self._data_group = None if mesh is None else mesh.data_group
        shard_model(model, mesh)
        self.train_pipe = train_pipe
        self.val_pipe = val_pipe
        self.test_pipe = test_pipe
        self.config = training_config
        self.loss_config = loss_config
        self.seed = int(training_config.get("seed", 0))

        self.experiment_name = training_config.get(
            "experiment_name", f"default_{int(time.time())}")
        self.logger = MetricsLogger(self.experiment_name, log_dir,
                                    enabled=self.main)
        self.checkpoints = CheckpointHandler(
            self.experiment_name, training_config.get("checkpoint_dir",
                                                      "checkpoints"), mesh)

        self.state = create_sharded_train_state(
            dict(model.named_parameters()), training_config, mesh,
            freeze_cad=model.config.use_pretrained_cad_model)
        self._train_step = make_train_step(
            model, loss_config, noise=training_config.get("noise", False),
            mesh=mesh)
        self._eval_step = make_eval_step(model, loss_config, mesh=mesh)
        self._eval_step_ablation = make_eval_step(model, loss_config,
                                                  ablate_cad=True, mesh=mesh)

        self.es_enabled = training_config.get("early_stopping_enabled", False)
        self.es_patience = training_config.get("early_stopping_patience", 100)
        self.es_min_delta = training_config.get("early_stopping_min_delta",
                                                0.0)
        self.es_metric = training_config.get("early_stopping_metric",
                                             "accuracy")
        self.es_mode = training_config.get("early_stopping_mode", "max")
        self.start_epoch = 0
        # Installed by train() when config["preemption_safe"] (default on);
        # _preempted records a mid-epoch stop inside _train_epoch.
        self._guard: Optional[PreemptionGuard] = None
        self._preempted = False

    # ------------------------------------------------------------------
    def log(self, message: str):
        if self.main:
            print(message, flush=True)

    def _put(self, batch: Dict) -> Dict:
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in _array_batch(batch).items()}

    # ------------------------------------------------------------------
    def resume(self, name: Optional[str] = None) -> bool:
        """Restore the latest (or named) checkpoint; True if resumed."""
        name = name or self.checkpoints.latest_epoch()
        if name is None:
            return False
        self.state, meta = self.checkpoints.restore(name, self.state)
        self.start_epoch = int(meta.get("epoch", 0))
        self.log(f"Resumed from {name} at epoch {self.start_epoch}")
        return True

    def train(self, epochs: int):
        best_value = float("inf") if self.es_mode == "min" else float("-inf")
        best_name = None
        patience = 0
        preempted = False
        profiling = self.config.get("enable_profiling", False)
        if self.config.get("preemption_safe", True):
            # SIGTERM becomes a clean save-and-stop instead of losing the
            # work since the last save_frequency checkpoint. Installed only
            # for the duration of train().
            self._guard = PreemptionGuard(
                group=None if self.mesh is None else self.mesh.world_group,
                device=self.model.device).install()
        try:
            for epoch in range(self.start_epoch, epochs):
                epoch_start = time.time()
                avg_loss, metrics = self._train_epoch(epoch, profiling)
                if self._preempted:
                    # The epoch is incomplete, so the checkpoint's meta
                    # says "resume AT this epoch" (restart it), not after.
                    self.checkpoints.save(self.state, epoch - 1, avg_loss)
                    self.log(f"Preempted during epoch {epoch + 1}; "
                             "checkpoint saved, resume restarts the epoch")
                    preempted = True
                    break
                self.logger.save(metrics, f"epoch_{epoch + 1}")
                self._log_epoch(epoch, epochs, avg_loss, metrics)

                if (epoch + 1) % self.config.get("save_frequency", 20) == 0:
                    self.checkpoints.save(self.state, epoch, avg_loss)

                val_metrics = self._run_validation(epoch)
                if self._guard is not None and self._guard.consensus():
                    self.checkpoints.save(self.state, epoch, avg_loss)
                    self.log(f"Preempted after epoch {epoch + 1}; "
                             "checkpoint saved")
                    preempted = True
                    break

                if self.es_enabled:
                    current = self._current_metric(avg_loss, val_metrics)
                    if current is None:
                        pass  # metric not measured this epoch
                    elif self._improved(current, best_value):
                        self.log(f"Validation {self.es_metric} improved "
                                 f"{best_value:.4f} -> {current:.4f}")
                        best_value, patience = current, 0
                        self.checkpoints.save(self.state, epoch, avg_loss,
                                              is_best=True)
                        best_name = "best_model"
                    else:
                        patience += 1
                        self.log(f"No improvement; patience "
                                 f"{patience}/{self.es_patience}")
                    if patience >= self.es_patience:
                        self.log(f"Early stopping after {epoch + 1} epochs")
                        break
                self.log(f"Epoch {epoch + 1} took "
                         f"{time.time() - epoch_start:.2f}s")
        finally:
            if self._guard is not None:
                self._guard.uninstall()
                self._guard = None

        # On preemption the best checkpoint may predate the just-saved
        # state; keep the latest weights so resume continues seamlessly.
        if self.es_enabled and best_name and not preempted:
            self.state, _ = self.checkpoints.restore(best_name, self.state)
            self.log("Loaded best model weights")
        self.checkpoints.wait()
        return self.state.params

    def _profiler(self, epoch: int):
        """A started ``torch.profiler`` over a wait / warm-up / active
        window of the epoch's steps, or None. An epoch shorter than the
        schedule is traced whole. The program's spans
        (``utils/trace.py``, whatever it held before is dropped) are
        recorded while it runs; those inside the profiled steps join
        ``trace.json`` on its time base, under the process ``spans``."""
        wait = int(self.config.get("profile_wait", 5))
        warmup = int(self.config.get("profile_warmup", 5))
        active = int(self.config.get("profile_active", 15))
        n_total = len(self.train_pipe)
        if n_total < wait + warmup + active:
            wait = warmup = 0
            active = max(n_total, 1)
        trace_dir = os.path.join(self.logger.dir, "profile_traces",
                                 f"epoch{epoch}")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)

        def ready(prof):
            trace.disable()
            path = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(path)
            steps = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("ProfilerStep#")
                     and e.device_type() == torch.autograd.DeviceType.CPU]
            spans = trace.drain()
            if steps:
                lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
                spans = [s for s in spans
                         if s.start_ns >= lo and s.end_ns <= hi]
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(trace.chrome_events(
                spans, doc.get("baseTimeNanoseconds", 0)))
            with open(path, "w") as f:
                json.dump(doc, f)
            self.log(f"Profiler trace ({active} steps) saved to {trace_dir}")

        prof = torch.profiler.profile(
            activities=activities, on_trace_ready=ready,
            schedule=torch.profiler.schedule(wait=wait, warmup=warmup,
                                             active=active, repeat=1))
        trace.drain()
        trace.enable()
        prof.start()
        return prof

    def _train_epoch(self, epoch: int, profiling: bool = False):
        """One epoch of stepping without host synchronisation.

        The loop never reads a device value: the loss and the metric
        counters accumulate on the device and are fetched in one copy at
        ``log_frequency`` boundaries and at the end of the epoch, so the
        host runs ahead of the device and the prefetched transfer of step
        N+1 overlaps step N.
        """
        log_every = int(self.config.get("log_frequency", 50))
        prof = self._profiler(epoch) if profiling else None
        host_batches = (_array_batch(batch)
                        for batch in self.train_pipe.epoch(epoch))
        loss_sum = None
        counters: Dict[str, torch.Tensor] = {}
        num_batches = 0
        self._preempted = False
        epoch_start = time.time()
        try:
            # Two batches stay in flight on the device.
            for batch in device_prefetch(host_batches, self.model.device,
                                         size=2):
                self.state, loss, batch_metrics = self._train_step(
                    self.state, batch, self.seed)
                if loss_sum is None:
                    loss_sum = loss.clone()
                    counters = {k: v.clone() for k, v in batch_metrics.items()}
                else:
                    loss_sum += loss
                    torch._foreach_add_(list(counters.values()),
                                        [batch_metrics[k] for k in counters])
                num_batches += 1
                if prof is not None:
                    prof.step()
                if log_every and num_batches % log_every == 0:
                    avg, metrics = self._snapshot(loss_sum, num_batches,
                                                  counters)
                    self._log_batch(epoch, num_batches, avg, metrics,
                                    (time.time() - epoch_start) / num_batches)
                    if self._guard is not None and self._guard.consensus():
                        self._preempted = True
                        self.log(f"Preemption signal at batch "
                                 f"{num_batches}; stopping epoch")
                        break
        finally:
            if prof is not None:
                prof.stop()
                trace.disable()     # if the window never completed
                trace.drain()
        if num_batches == 0:
            return 0.0, init_metrics()
        return self._snapshot(loss_sum, num_batches, counters)

    def _snapshot(self, loss_sum, num_batches, counters):
        """Fetch the device-side accumulators (summed over the data group)
        in one copy and derive the percentages."""
        values = all_reduce(torch.stack([loss_sum, *counters.values()]),
                            self._data_group).tolist()
        metrics = init_metrics()
        update_metrics(metrics, dict(zip(counters, values[1:])))
        return values[0] / num_batches, metrics

    def _run_validation(self, epoch: int):
        val_metrics = None
        if ((epoch + 1) % self.config.get("seq_val_frequency", 30) == 0
                and self.config.get("sequential", False)):
            val_metrics = self.sequential_evaluate(mode="val")
        if (epoch + 1) % self.config.get("val_frequency", 4) == 0:
            val_metrics = self.evaluate(mode="val", epoch=epoch)
        return val_metrics

    def _current_metric(self, avg_loss, val_metrics):
        """The early-stopping metric for this epoch, or None when the
        configured metric is unavailable (accuracy on an epoch without
        validation): a loss in its place would poison a max-mode best."""
        if self.es_metric == "loss":
            return avg_loss
        if (self.es_metric == "accuracy" and val_metrics
                and val_metrics.get("total_predictions", 0) > 0):
            return (val_metrics["correct_predictions"]
                    / val_metrics["total_predictions"])
        return None

    def _improved(self, current, best):
        if self.es_mode == "min":
            return current < best - self.es_min_delta
        return current > best + self.es_min_delta

    # ------------------------------------------------------------------
    def _loader(self, mode: str):
        mode = mode.replace("_seq", "")
        return {"train": self.train_pipe, "val": self.val_pipe,
                "test": self.test_pipe}[mode]

    def _accumulate(self, sums: Dict, batch_metrics: Dict) -> None:
        """Add a batch's counters to ``sums`` on the device."""
        if not sums:
            sums.update({k: v.clone() for k, v in batch_metrics.items()})
        else:
            torch._foreach_add_(list(sums.values()),
                                [batch_metrics[k] for k in sums])

    def _metrics(self, sums: Dict) -> Dict:
        """The counters summed over the data group, fetched in one copy,
        with the derived percentages."""
        metrics = init_metrics()
        if sums:
            values = all_reduce(torch.stack(list(sums.values())),
                                self._data_group).tolist()
            update_metrics(metrics, dict(zip(sums, values)))
        return metrics

    def evaluate(self, mode: str = "test", ablation: bool = False,
                 epoch: int = -1) -> Dict:
        sums: Dict[str, torch.Tensor] = {}
        step = self._eval_step_ablation if ablation else self._eval_step
        for batch in self._loader(mode).epoch(0):
            _, batch_metrics = step(self._put(batch))
            self._accumulate(sums, batch_metrics)
        metrics = self._metrics(sums)
        ext = f"{mode}_epoch_{epoch + 1}" if epoch != -1 else mode
        self.logger.save(metrics, ext)
        return metrics

    def sequential_evaluate(self, mode: str = "test",
                            ablation: bool = False) -> Dict:
        """Rollout evaluation over a split via the KV-cached decode."""
        sums: Dict[str, torch.Tensor] = {}
        for batch in self._loader(mode).epoch(0):
            device_batch = self._put(batch)
            cad = device_batch["cad_image"]
            if ablation:
                cad = torch.zeros_like(cad)
            # The rollout consumes frames[:, :-1] (teacher forcing never
            # sees the final frame either) and predicts steps 1..T.
            cmd_logits, param_logits = sequential_inference(
                self.model, device_batch["frames"][:, :-1], cad,
                action=self.model.config.enable_past_actions,
                multiview_images=device_batch.get("multiview_images"))
            _, batch_metrics = compute_loss_and_metrics(
                cmd_logits, param_logits, device_batch["actions"][:, 1:],
                self.loss_config, self._data_group)
            self._accumulate(sums, batch_metrics)
        metrics = self._metrics(sums)
        self.logger.save(metrics, f"{mode}_seq")
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_forward(self, model_inputs):
        was_training = self.model.training
        self.model.eval()
        try:
            return self.model(model_inputs)
        finally:
            self.model.train(was_training)

    def _predictions(self, batch: Dict, ablation: bool):
        """(device batch, targets, cmd_pred, masked param_pred) of the
        teacher-forced forward."""
        device_batch = self._put(batch)
        if ablation:
            device_batch["cad_image"] = torch.zeros_like(
                device_batch["cad_image"])
        model_inputs, targets = prepare_model_inputs(device_batch)
        cmd_logits, param_logits = self._eval_forward(model_inputs)
        cmd_pred = cmd_logits.argmax(dim=-1)
        param_pred = apply_action_mask(cmd_pred, param_logits.argmax(dim=-1))
        return device_batch, targets, cmd_pred, param_pred

    def sample(self, n: int = 10, folder: str = "outputs",
               mode: str = "test", ablation: bool = False):
        """Teacher-forced per-sample prediction CSVs."""
        os.makedirs(folder, exist_ok=True)
        count = 0
        for batch in self._loader(mode).epoch(0):
            device_batch, _, cmd_pred, param_pred = self._predictions(
                batch, ablation)
            pred = torch.cat([cmd_pred[..., None], param_pred],
                             dim=-1).cpu().numpy()
            actions = device_batch["actions"].cpu().numpy()
            cad_images = np.asarray(batch["cad_image"])
            ids = batch.get("ids",
                            [str(count + i) for i in range(pred.shape[0])])
            for i, sample_id in enumerate(ids):
                self._save_cad_png(cad_images[i], os.path.join(
                    folder, f"images_{sample_id}.png"))
                with open(os.path.join(
                        folder, f"pred_actions_{sample_id}.csv"), "w",
                        newline="") as f:
                    csv.writer(f).writerows(pred[i].tolist())
                with open(os.path.join(
                        folder, f"actions_{sample_id}.csv"), "w",
                        newline="") as f:
                    csv.writer(f).writerows(actions[i, 1:].tolist())
                count += 1
                if count >= n:
                    return

    @staticmethod
    def _save_cad_png(cad: np.ndarray, path: str):
        """Save a (possibly normalized float) CAD image as a PNG."""
        from PIL import Image
        if cad.dtype != np.uint8:
            cad = np.clip((cad * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        if cad.ndim == 3 and cad.shape[-1] == 1:
            cad = cad[..., 0]
        Image.fromarray(cad).save(path)

    # ------------------------------------------------------------------
    def find_first_mistake(self, mode: str = "test", tol: int = 3,
                           ablation: bool = False):
        """Per-sequence first-error analysis: for each tolerance level,
        the first mistaken prediction, the (gt, pred) memory per field,
        sequence lengths, and mistake masks."""
        data = [_init_mistake_bucket() for _ in range(tol)]
        for batch in self._loader(mode).epoch(0):
            _, targets, cmd_pred, param_pred = self._predictions(batch,
                                                                 ablation)
            targets = targets.to(torch.int64)
            for t in range(tol):
                bucket = data[t]
                for seq in self._sequence_mistakes(
                        targets[..., 0], targets[..., 1:], cmd_pred,
                        param_pred, t):
                    for key, vals in seq["First Mistakes"].items():
                        bucket["First Mistakes"][key].extend(vals)
                    for key, vals in seq["Memory"].items():
                        bucket["Memory"][key].extend(vals)
                    bucket["Sequence Lengths"].append(seq["Sequence Lengths"])
                    bucket["Number of Mistakes"].append(
                        seq["Number of Mistakes"])
        return data

    _sequence_mistakes = staticmethod(sequence_mistakes)

    # ------------------------------------------------------------------
    def _log_batch(self, epoch, batch_idx, avg_loss, metrics, sec_per_step):
        self.logger.save(metrics, f"epoch_{epoch + 1}")
        self.log(f"Epoch [{epoch + 1}], Batch [{batch_idx}], "
                 f"Loss: {avg_loss:.4f}, "
                 f"CMD Acc: {metrics['cmd_accuracy']:.2f}%, "
                 f"Params Acc: {metrics['params_accuracy']:.2f}%, "
                 f"{sec_per_step:.3f}s/step")

    def _log_epoch(self, epoch, epochs, avg_loss, metrics):
        acc = (100 * metrics["correct_predictions"]
               / max(metrics["total_predictions"], 1))
        self.log(f"Epoch [{epoch + 1}/{epochs}] Avg Loss: {avg_loss:.4f}, "
                 f"Accuracy: {acc:.2f}%, "
                 f"CMD: {metrics['cmd_accuracy']:.2f}%, "
                 f"Params: {metrics['params_accuracy']:.2f}%, "
                 f"Top-30 CMD: {metrics['cmd_accuracy_topk']:.2f}%")
