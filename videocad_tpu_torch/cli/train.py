"""Train CLI on one device.

    python -m videocad_tpu_torch.cli.train \
        --dataset_path data/data_resized \
        --config_path data/data_resized/dataset_split.json \
        --model_config model_configs/transformer_experiments.json \
        --model_name cad_past_10_actions_and_states_timestep_embedding \
        --device cuda

The arguments of ``videocad_tpu.cli.train``, plus ``--device``. The port
never moves to another device than the one asked for: ``--device cuda``
without a card is an error. ``--native_loader`` reads batches through the
C++ ``.vcb`` loader (``data/native.py``), converting the store into
``--vcb_dir`` on first use; ``--quant`` puts the dense layers on int8
products. Parallel meshes (``--data_parallel``, ``--model_parallel``,
``--dcn_slices``) are not ported yet and raise, naming their ROADMAP item;
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
    if getattr(args, "native_loader", False):
        return _build_native_pipelines(args, splits, view_ids,
                                       gencad=gencad, image_size=image_size)
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


def _build_native_pipelines(args, splits, view_ids=(), gencad=False,
                            image_size=None):
    """The C++ loader over ``.vcb`` shards, converted from the store on
    first use.

    A multiview config needs version-2 shards that carry its views, a
    GenCAD config version-3 shards that carry the 256 x 256 x 3 edge image;
    a store converted for another config is refused here, with what to do,
    rather than as a shape error inside the model.
    """
    import os

    from videocad_tpu_torch.data.native import (NativePipeline,
                                                convert_store_to_vcb,
                                                scan_vcb)
    from videocad_tpu_torch.models.videocadformer import GENCAD_IMAGE_SHAPE

    num_views = len(view_ids)
    vcb_root = args.vcb_dir or os.path.join(args.dataset_path, "..",
                                            "vcb_store")
    bucket = max(args.buckets or DEFAULT_BUCKETS)
    pipes = {}
    for split in ("train", "val", "test"):
        split_dir = os.path.join(vcb_root, split)
        paths = scan_vcb(split_dir)
        if not paths:
            convert_store_to_vcb(args.dataset_path, split_dir,
                                 ids=splits.get(split, []),
                                 view_ids=view_ids or None,
                                 multiview_dir=args.multiview_dir,
                                 gencad=gencad, image_size=image_size)
            paths = scan_vcb(split_dir)
        shape, stored_views, cad_shape = _probe_shape(paths[0])
        if stored_views != num_views:
            raise ValueError(
                f"{split_dir} holds .vcb shards with {stored_views} views "
                f"but the model config needs {num_views}; re-convert the "
                f"store (delete {vcb_root} or pass a fresh --vcb_dir) so "
                f"the requested views are packed in")
        if gencad and cad_shape != GENCAD_IMAGE_SHAPE:
            # Frame-shaped CAD images would train the frozen encoder on
            # raw renders instead of edges.
            raise ValueError(
                f"{split_dir} holds .vcb shards whose CAD image is "
                f"{cad_shape}, not the preprocessed GenCAD edge image "
                f"{GENCAD_IMAGE_SHAPE}; re-convert the store (delete "
                f"{vcb_root} or pass a fresh --vcb_dir) so conversion runs "
                f"the Canny preprocessing")
        if not gencad and cad_shape != shape:
            raise ValueError(
                f"{split_dir} holds GenCAD-converted .vcb shards (CAD "
                f"image {cad_shape}) but the model config does not set "
                f"use_pretrained_cad_model; re-convert the store (delete "
                f"{vcb_root} or pass a fresh --vcb_dir)")
        # One process on one card: the whole shuffled order (slice 9 of
        # the ROADMAP brings host shards).
        pipes[split] = NativePipeline(
            paths, batch_size=args.batch_size, bucket_len=bucket,
            image_shape=shape, num_views=num_views, cad_shape=cad_shape,
            shuffle=split == "train", host_id=0, num_hosts=1)
    return pipes


def _probe_shape(path):
    """((H, W, C), num_views, cad_shape) from a ``.vcb`` header (versions
    1-3)."""
    import struct

    with open(path, "rb") as f:
        header = struct.unpack("<7I", f.read(28))
        views = struct.unpack("<I", f.read(4))[0] if header[1] >= 2 else 0
        shape = (header[3], header[4], header[5])
        cad_shape = (struct.unpack("<3I", f.read(12)) if header[1] >= 3
                     else shape)
    return shape, views, tuple(cad_shape)


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
                        help="use the C++ .vcb loader (converts the store "
                             "on first use)")
    parser.add_argument("--vcb_dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--enable_profiling", action="store_true")
    parser.add_argument("--sequential", action="store_true",
                        help="periodic rollout validation")
    parser.add_argument("--quant", default=None,
                        choices=["none", "int8", "int8_bwd"],
                        help="int8 dense layers: 'int8' quantizes the "
                             "forwards with straight-through gradients; "
                             "'int8_bwd' also quantizes the backward "
                             "matmuls. Overrides the model config's "
                             "'quant' key.")
    return parser.parse_args(argv)


def _check_ported(args) -> None:
    unported = [
        (args.data_parallel > 1, "--data_parallel (ROADMAP slice 9)"),
        (args.model_parallel > 1, "--model_parallel (ROADMAP slice 9)"),
        (args.dcn_slices > 1, "--dcn_slices (ROADMAP slice 9)"),
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
