"""Export a model into a .vcdx serving artifact (the port's format).

    python -m videocad_tpu_torch.cli.export_model \
        --model_config model_configs/transformer_experiments.json \
        --model_name cad_past_10_actions_and_states_timestep_embedding \
        --checkpoint checkpoints/<experiment>/best_model --batch 1 \
        --bucket 187 --lanes 8 --weight_quant int8 --out serve/flagship.vcdx

The counterpart of ``tools/export_model.py``, with its flags. The artifact
holds the config, the meta and float32 weights, and no programs
(``infer/export.py``); ``python -m videocad_tpu_torch.cli.serve --artifact``
serves it. ``--checkpoint`` takes a checkpoint directory of the port's
trainer or JAX weights (a ``params.npz`` or a ``.vcdx``); without it the
artifact holds random weights from seed 0 (a format smoke). The model is
built on ``--device`` (the card unless the CPU is asked for).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_config", required=True,
                    help="model_configs JSON file")
    ap.add_argument("--model_name", required=True,
                    help="named config inside the JSON")
    ap.add_argument("--checkpoint", default=None,
                    help="a port checkpoint directory, or JAX weights "
                         "(params.npz or .vcdx)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bucket", type=int, default=192)
    ap.add_argument("--no_rollout", action="store_true")
    ap.add_argument("--weight_quant", default="none",
                    choices=["none", "int8", "int4"],
                    help="the decode mode the artifact is served in: the "
                         "decoder quantized at load (w8a16 / w4a16); the "
                         "weights stay float32 in the artifact")
    ap.add_argument("--lanes", type=int, default=0,
                    help="serve N multiplexed sessions from the artifact "
                         "(cli.serve --artifact then runs "
                         "ArtifactMuxEngine)")
    ap.add_argument("--out", required=True, help=".vcdx output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to build the model on")
    return ap.parse_args(argv)


def main(argv=None):
    import torch

    from videocad_tpu_torch.experiment import load_warm_start
    from videocad_tpu_torch.infer.export import export_model
    from videocad_tpu_torch.models.factory import (create_model,
                                                   load_named_config)

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (the port does not fall back to CPU)")
    config = load_named_config(args.model_config, args.model_name)
    model = create_model(config, device=device)
    if args.checkpoint:
        load_warm_start(model, args.checkpoint)
    meta = export_model(config, model, args.batch, args.bucket, args.out,
                        with_rollout=not args.no_rollout,
                        weight_quant=args.weight_quant, lanes=args.lanes)
    print(json.dumps({"out": args.out, **meta}))
    return meta


if __name__ == "__main__":
    main()
