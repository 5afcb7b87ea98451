"""Serving CLI: expose a live model over HTTP on one device.

    python -m videocad_tpu_torch.cli.serve \
        --model_config model_configs/transformer_experiments.json \
        --model_name cad_past_10_actions_and_states_timestep_embedding \
        --device cuda --lanes 8 [--jax_params params.npz | model.vcdx]

Without ``--jax_params`` the model serves random weights from seed 0 (a
protocol smoke). The protocol is that of ``videocad_tpu.cli.serve``; the stdlib
client is ``videocad_tpu_torch.infer.server.ServingClient``. The port
never moves to another device than the one asked for: ``--device cuda``
without a card is an error.
"""

from __future__ import annotations

import argparse
import json


def build_engine(args):
    """The live-model engine the arguments describe."""
    import torch

    from videocad_tpu_torch.infer.server import MuxEngine
    from videocad_tpu_torch.models.convert import (load_jax_params,
                                                   state_dict_from_jax)
    from videocad_tpu_torch.models.factory import create_model

    if args.artifact:
        raise NotImplementedError(
            "serving a .vcdx artifact's programs is not ported yet (ROADMAP "
            "slice 10); pass its weights with --jax_params model.vcdx")
    if args.checkpoint_folder:
        raise NotImplementedError(
            "checkpoint restore is not ported yet (ROADMAP slice 8); pass "
            "JAX weights with --jax_params")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (the port does not fall back to CPU)")
    with open(args.model_config) as f:
        model_params = json.load(f)[args.model_name]
    model = create_model(model_params, device=device,
                         generator=torch.Generator().manual_seed(0))
    if args.jax_params:
        tree, _ = load_jax_params(args.jax_params)
        model.load_state_dict(state_dict_from_jax(tree))
    return MuxEngine(model, lanes=args.lanes, seq_len=args.seq_len,
                     weight_quant=args.weight_quant,
                     session_ttl_s=args.session_ttl)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Serve incremental CAD-agent decode over HTTP")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (no silent CPU "
                             "fallback)")
    parser.add_argument("--jax_params", default=None,
                        help="JAX weights: a params.npz of '/'-joined keys "
                             "or a .vcdx artifact; omit to serve seeded "
                             "random weights (protocol smoke)")
    parser.add_argument("--artifact", default=None,
                        help=".vcdx programs (not ported yet)")
    parser.add_argument("--model_config",
                        default="model_configs/transformer_experiments.json")
    parser.add_argument("--model_name",
                        default="cad_past_10_actions_and_states_timestep_embedding")
    parser.add_argument("--checkpoint_folder", default=None,
                        help="Orbax checkpoint (not ported yet)")
    parser.add_argument("--lanes", type=int, default=4,
                        help="concurrent sessions multiplexed per device "
                             "step")
    parser.add_argument("--seq_len", type=int, default=187,
                        help="per-session step horizon (the reference's "
                             "186-action episodes + zero-action start)")
    parser.add_argument("--weight_quant", default="none",
                        choices=["none", "int8", "int4"],
                        help="decoder weight quantization (only 'none' is "
                             "ported yet)")
    parser.add_argument("--session_ttl", type=float, default=None,
                        help="evict sessions idle this many seconds when "
                             "lanes are requested; omit to never evict")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8741)
    return parser.parse_args(argv)


def main(argv=None):
    from videocad_tpu_torch.infer.server import make_server

    args = parse_args(argv)
    engine = build_engine(args)
    server = make_server(engine, args.host, args.port)
    meta = engine.meta()
    print(f"serving {meta['engine']} engine on {meta['device']} at "
          f"http://{args.host}:{server.server_address[1]} "
          f"(lanes={meta['lanes']}, seq_len={meta['seq_len']})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()
        server.server_close()


if __name__ == "__main__":
    main()
