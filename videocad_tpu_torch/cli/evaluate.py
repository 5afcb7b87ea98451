"""Checkpoint-evaluation CLI on one device.

    python -m videocad_tpu_torch.cli.evaluate \\
        --checkpoint_folder <experiment_name> \\
        --dataset_path data/data_resized --device cuda ...

The arguments of ``videocad_tpu.cli.evaluate``, plus ``--device`` (``cuda``
without a card is an error, never a move to the CPU). Loads ``best_model``
(or a named checkpoint) of the port's trainer, dumps the per-sample
prediction CSVs of the test split, runs the first-mistake analysis at
``--tol`` on val and test, renders the plot suite, and reports the final
teacher-forced metrics on both splits (and the rollout's on the test split
with ``--sequential``). Returns what it computed, for callers that check it.

One deviation from the JAX CLI: matplotlib is an optional dependency, and
where it cannot be imported the plot suite is skipped with a printed line;
everything else runs.
"""

from __future__ import annotations

import argparse
import os

from videocad_tpu_torch.cli.plots import matplotlib_available, run_plot_suite
from videocad_tpu_torch.cli.train import build_pipelines
from videocad_tpu_torch.experiment import default_loss_config
from videocad_tpu_torch.models.factory import create_model
from videocad_tpu_torch.train.checkpoint import CheckpointHandler
from videocad_tpu_torch.train.trainer import Trainer
from videocad_tpu_torch.utils.io import load_json


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Evaluate a VideoCADFormer checkpoint on one device")
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on (no silent CPU "
                             "fallback)")
    parser.add_argument("--dataset_path", default="data/data_resized")
    parser.add_argument("--config_path",
                        default="data/data_resized/dataset_split.json")
    parser.add_argument("--image_dir", default=None)
    parser.add_argument("--multiview_dir", default=None)
    parser.add_argument("--model_config",
                        default="model_configs/transformer_experiments.json")
    parser.add_argument("--model_name",
                        default="cad_past_10_actions_and_states_timestep_embedding")
    parser.add_argument("--class_weights", default="class_weights.json")
    parser.add_argument("--checkpoint_folder", required=True)
    parser.add_argument("--checkpoint_name", default="best_model")
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--output_root_dir", default="test")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--buckets", type=int, nargs="*", default=None)
    parser.add_argument("--enable_random", action="store_true", default=False)
    parser.add_argument("--tol", type=int, default=10)
    parser.add_argument("--sequential", action="store_true",
                        help="also run rollout (sequential) evaluation")
    return parser.parse_args(argv)


def _accuracies(metrics):
    return {k: round(v, 2) for k, v in metrics.items()
            if k.endswith("accuracy")}


def main(argv=None):
    import torch

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (the port does not fall back to CPU)")

    name = args.checkpoint_folder
    plots_dir = os.path.join(args.output_root_dir, name, "plots")
    samples_dir = os.path.join(args.output_root_dir, name, "samples")
    os.makedirs(plots_dir, exist_ok=True)
    os.makedirs(samples_dir, exist_ok=True)

    model_params = load_json(args.model_config)[args.model_name]
    view_ids = ["05", "09", "20"][: model_params.get("num_views", 0)]
    pipes = build_pipelines(args, view_ids, model_params)

    model = create_model(model_params, device=device)
    training_config = {
        "lr": 1e-5, "use_mse": True,
        "experiment_name": name,
        "checkpoint_dir": args.checkpoint_dir,
    }
    loss_config = default_loss_config(training_config, args.class_weights)
    trainer = Trainer(model, pipes["train"], pipes["val"], pipes["test"],
                      training_config, loss_config,
                      log_dir=os.path.join(args.output_root_dir, name, "logs"))

    handler = CheckpointHandler(args.checkpoint_folder, args.checkpoint_dir)
    trainer.state, _ = handler.restore(args.checkpoint_name, trainer.state)

    trainer.sample(n=10 ** 9, folder=samples_dir, mode="test")

    plots = matplotlib_available()
    if not plots:
        print("matplotlib is not installed: the plot suite is skipped")
    mistakes = {}
    for mode in ("val", "test"):
        mistakes[mode] = trainer.find_first_mistake(mode=mode, tol=args.tol)
        if plots:
            run_plot_suite(mistakes[mode], plots_dir, name, mode=mode)

    results = {"first_mistakes": mistakes, "plots": plots}
    print("\nEvaluating on Validation Set:")
    results["val"] = trainer.evaluate(mode="val")
    print(_accuracies(results["val"]))
    print("\nEvaluating on Test Set:")
    results["test"] = trainer.evaluate(mode="test")
    print(_accuracies(results["test"]))
    if args.sequential:
        print("\nSequential (rollout) evaluation on Test Set:")
        results["test_seq"] = trainer.sequential_evaluate(mode="test")
        print(_accuracies(results["test_seq"]))
    return results


if __name__ == "__main__":
    main()
