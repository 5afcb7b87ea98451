"""Train CLI on one device.

    python -m videocad_tpu_torch.cli.train \
        --dataset_path data/data_resized \
        --config_path data/data_resized/dataset_split.json \
        --model_config model_configs/transformer_experiments.json \
        --model_name cad_past_10_actions_and_states_timestep_embedding \
        --device cuda

The arguments of ``videocad_tpu.cli.train``, plus ``--device``. The port
never moves to another device than the one asked for: ``--device cuda``
without a card is an error. Parallel meshes, the native ``.vcb`` loader and
int8 dense layers are not ported yet and raise, naming their ROADMAP item;
``--dropout_rng_impl`` (a choice between JAX generators) has no
counterpart.
"""

from __future__ import annotations

import argparse

from videocad_tpu_torch.data.collate import DEFAULT_BUCKETS
from videocad_tpu_torch.data.dataset import VideoCADDataset, load_split_ids
from videocad_tpu_torch.data.pipeline import DataPipeline
from videocad_tpu_torch.experiment import Experiment
from videocad_tpu_torch.utils.io import load_json


def build_pipelines(args, view_ids, model_params=None):
    """The train, val and test pipelines over the dataset the arguments
    name."""
    model_params = model_params or {}
    gencad = bool(model_params.get("use_pretrained_cad_model", False))
    image_size = model_params.get("image_size")
    splits = load_split_ids(args.config_path)
    pipes = {}
    for split in ("train", "val", "test"):
        ds = VideoCADDataset(
            args.dataset_path, ids=splits.get(split, []),
            image_dir=args.image_dir,
            enable_random=args.enable_random and split == "train",
            view_ids=view_ids, multiview_dir=args.multiview_dir,
            image_size=image_size, gencad=gencad)
        pipes[split] = DataPipeline(
            ds, batch_size=args.batch_size, shuffle=split == "train",
            buckets=tuple(args.buckets or DEFAULT_BUCKETS))
    return pipes


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train VideoCADFormer on one device")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (no silent CPU "
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
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--enable_random", action="store_true", default=True)
    parser.add_argument("--no_enable_random", dest="enable_random",
                        action="store_false")
    parser.add_argument("--noise", action="store_true",
                        help="action-noise augmentation")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="not ported yet (ROADMAP slice 9)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="not ported yet (ROADMAP slice 9)")
    parser.add_argument("--dcn_slices", type=int, default=1,
                        help="not ported yet (ROADMAP slice 9)")
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--buckets", type=int, nargs="*", default=None)
    parser.add_argument("--native_loader", action="store_true",
                        help="the C++ .vcb loader: not ported yet (ROADMAP "
                             "slice 8, data/native.py)")
    parser.add_argument("--vcb_dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--enable_profiling", action="store_true")
    parser.add_argument("--sequential", action="store_true",
                        help="periodic rollout validation")
    parser.add_argument("--quant", default=None,
                        choices=["none", "int8", "int8_bwd"],
                        help="int8 dense layers: not ported yet (ROADMAP "
                             "slice 11); overrides the model config's "
                             "'quant' key")
    return parser.parse_args(argv)


def _check_ported(args) -> None:
    unported = [
        (args.data_parallel > 1, "--data_parallel (ROADMAP slice 9)"),
        (args.model_parallel > 1, "--model_parallel (ROADMAP slice 9)"),
        (args.dcn_slices > 1, "--dcn_slices (ROADMAP slice 9)"),
        (args.native_loader,
         "--native_loader (ROADMAP slice 8, data/native.py)"),
        (args.quant not in (None, "none"),
         f"--quant {args.quant} (ROADMAP slice 11)"),
    ]
    missing = [what for bad, what in unported if bad]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def main(argv=None):
    import torch

    args = parse_args(argv)
    _check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (the port does not fall back to CPU)")

    model_configs = load_json(args.model_config)
    model_params = model_configs[args.model_name]
    if args.quant is not None:
        model_params["quant"] = args.quant
    view_ids = ["05", "09", "20"][: model_params.get("num_views", 0)]
    pipes = build_pipelines(args, view_ids, model_params)

    # the reference's training_config defaults
    training_config = {
        "lr": args.lr,
        "batch_size": args.batch_size,
        "save_frequency": 20,
        "val_frequency": 4,
        "seq_val_frequency": 1100,
        "sequential": args.sequential,
        "epochs": args.epochs,
        "early_stopping_enabled": True,
        "early_stopping_patience": 10,
        "early_stopping_min_delta": 0.001,
        "early_stopping_metric": "loss",
        "early_stopping_mode": "min",
        "use_mse": True,
        "noise": args.noise,
        "checkpoint_dir": args.checkpoint_dir,
        "enable_profiling": args.enable_profiling,
        "resume": args.resume,
    }

    experiment = Experiment(pipes["train"], pipes["val"], pipes["test"],
                            training_config, device=device,
                            log_dir=args.log_dir,
                            class_weights_path=args.class_weights)
    return experiment.run_with_config(model_configs, args.model_name)


if __name__ == "__main__":
    main()
