"""Offline ETL CLI: raw (videos, mouse logs, CAD images) -> training store.

Port of ``videocad_tpu/cli/generate_dataset.py``; host only, it takes no
device. One command covers both reference entry points:

  * ``python -m videocad_tpu_torch.cli.generate_dataset --raw_dir
    data/data_raw --out_dir data/data_resized`` — the full pipeline of the
    reference's ``python generate_dataset.py``: parse each video's mouse
    log to 7-dim action vectors, seek the video to each action timestamp,
    resize, prepend the zero-action / duplicated-first-frame pair, truncate
    at the end sentinel, and write the sharded
    ``<out>/<id[:4]>/<id>_data.pkl`` store + CAD PNGs. It decodes video
    with OpenCV and refuses (exit code 2) where OpenCV is not installed.
  * ``--stage logs_to_json`` / ``--stage json_to_vectors`` — the two batch
    converters of the reference's ``python transform_dataset.py``: raw
    ``mouse/*.log`` -> parsed JSON, and parsed JSON -> sentinel-truncated
    (actions, timesteps) pickles + CSVs. Neither needs OpenCV.

With ``--vcb_dir`` the freshly generated pickle store is additionally
packed into ``.vcb`` shards for the C++ native loader (the format
``cli/train.py --native_loader`` otherwise converts on demand at first
training run) — one command from raw captures to a training-ready store.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stage", default="generate",
                        choices=("generate", "logs_to_json",
                                 "json_to_vectors"),
                        help="generate: full video+log+image pipeline "
                             "(reference generate_dataset.py); the other "
                             "two: the transform_dataset.py batch "
                             "converters")
    parser.add_argument("--raw_dir", default="data/data_raw",
                        help="stage=generate: root with videos/, mouse/, "
                             "images/ subdirs")
    parser.add_argument("--out_dir", default="data/data_resized",
                        help="stage=generate: sharded pickle-store output")
    parser.add_argument("--source_dir",
                        help="stage=logs_to_json|json_to_vectors: input dir "
                             "(.log files / parsed .json files)")
    parser.add_argument("--target_dir",
                        help="stage=logs_to_json|json_to_vectors: output dir")
    parser.add_argument("--is_filtered", action="store_true",
                        help="stage=logs_to_json: logs are pre-filtered "
                             "(reference process_logs is_filtered)")
    parser.add_argument("--resize", type=int, nargs=2, default=(224, 224),
                        metavar=("H", "W"),
                        help="stage=generate: frame resize (reference "
                             "default 224 224)")
    parser.add_argument("--vcb_dir", default=None,
                        help="stage=generate: also pack the store into .vcb "
                             "shards here (per split when --split_json "
                             "names one, else a single 'all' split)")
    parser.add_argument("--split_json", default=None,
                        help="dataset_split.json mapping id -> "
                             "train|val|test for the .vcb packing")
    parser.add_argument("--view_ids", nargs="*", default=None,
                        help=".vcb packing: multiview render ids to pack")
    parser.add_argument("--multiview_dir", default=None,
                        help=".vcb packing: directory of multiview renders")
    parser.add_argument("--gencad", action="store_true",
                        help=".vcb packing: pack Canny-edge GenCAD CAD "
                             "images (256x256x3)")
    args = parser.parse_args(argv)

    if args.stage == "logs_to_json":
        from videocad_tpu_torch.etl.dataset_gen import convert_log_dir_to_json
        if not (args.source_dir and args.target_dir):
            parser.error("--stage logs_to_json needs --source_dir and "
                         "--target_dir")
        written = convert_log_dir_to_json(args.source_dir, args.target_dir,
                                          args.is_filtered)
        print(f"logs_to_json: wrote {len(written)} files to "
              f"{args.target_dir}")
        return 0

    if args.stage == "json_to_vectors":
        from videocad_tpu_torch.etl.dataset_gen import json_dir_to_vectors
        if not (args.source_dir and args.target_dir):
            parser.error("--stage json_to_vectors needs --source_dir and "
                         "--target_dir")
        written = json_dir_to_vectors(args.source_dir, args.target_dir)
        print(f"json_to_vectors: wrote {len(written)} sequences to "
              f"{args.target_dir}")
        return 0

    from videocad_tpu_torch.etl.dataset_gen import HAVE_CV2, generate_dataset
    if not HAVE_CV2:
        parser.error("stage=generate decodes video via OpenCV, which is "
                     "not installed in this environment")
    done = generate_dataset(args.raw_dir, args.out_dir, tuple(args.resize))
    print(f"generate: processed {len(done)} sequences -> {args.out_dir}")

    if args.vcb_dir:
        from videocad_tpu_torch.data.dataset import load_split_ids
        from videocad_tpu_torch.data.native import convert_store_to_vcb
        if args.split_json:
            splits = load_split_ids(args.split_json)
        else:
            splits = {"all": done}
        for split, ids in splits.items():
            n = convert_store_to_vcb(
                args.out_dir, os.path.join(args.vcb_dir, split), ids=ids,
                view_ids=args.view_ids or None,
                multiview_dir=args.multiview_dir, gencad=args.gencad)
            print(f"vcb[{split}]: packed {n} shards")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
