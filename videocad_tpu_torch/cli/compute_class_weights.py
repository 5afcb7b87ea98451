"""Derive class_weights.json from a dataset.

Port of ``tools/compute_class_weights.py``, reading the port's
``VideoCADDataset``; host only, it takes no device. The reference ships a
class_weights.json of dataset statistics (inverse class frequencies,
mean-normalized) consumed by the loss (``cli/train.py --class_weights``,
``experiment.py:default_loss_config``). This entry recomputes the same
structure from any sharded VideoCAD store:

  * "Label": 5 command-class weights, w_c ∝ 1/count_c, normalized so
    sum(w) == 1;
  * per-param 1000-bin weights, w_b ∝ 1/count_b over labeled (non -1)
    values, zero for unseen bins, normalized so mean(w) == 1/1000.

    python -m videocad_tpu_torch.cli.compute_class_weights <dataset_dir> \
        [out.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from videocad_tpu_torch.actions.vocab import (NUM_BINS, NUM_COMMANDS,
                                              PARAM_NAMES)
from videocad_tpu_torch.data.dataset import VideoCADDataset


def compute_weights(dataset: VideoCADDataset) -> dict:
    cmd_counts = np.zeros(NUM_COMMANDS)
    bin_counts = np.zeros((6, NUM_BINS))
    for i in range(len(dataset)):
        actions = dataset[i]["actions"].astype(np.int64)
        cmds = actions[:, 0]
        cmd_counts += np.bincount(cmds[cmds >= 0], minlength=NUM_COMMANDS)
        for p in range(6):
            vals = actions[:, 1 + p]
            vals = vals[vals >= 0]
            bin_counts[p] += np.bincount(vals, minlength=NUM_BINS)

    out = {}
    inv = np.where(cmd_counts > 0, 1.0 / np.maximum(cmd_counts, 1), 0.0)
    out["Label"] = (inv / inv.sum()).tolist()
    for p in range(6):
        counts = bin_counts[p]
        inv = np.where(counts > 0, 1.0 / np.maximum(counts, 1), 0.0)
        if inv.sum() > 0:
            inv = inv / inv.sum()  # mean == 1/NUM_BINS
        out[PARAM_NAMES[p + 1]] = inv.tolist()
    return out


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: python -m "
                         "videocad_tpu_torch.cli.compute_class_weights "
                         "<dataset_dir> [out.json]")
    out_path = argv[1] if len(argv) > 1 else "class_weights.json"
    weights = compute_weights(VideoCADDataset(argv[0]))
    with open(out_path, "w") as f:
        json.dump(weights, f)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
