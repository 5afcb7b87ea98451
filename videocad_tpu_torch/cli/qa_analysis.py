"""Majority-vote QA analysis CLI (reference qa_analysis.py surface).

Port of ``videocad_tpu/cli/qa_analysis.py``; host only, it takes no device.

    python -m videocad_tpu_torch.cli.qa_analysis --qa_dataset_path data/qa.json \
        --model_dirs results/gpt-4.1 results/claude-3-7
"""

from __future__ import annotations

import argparse

from videocad_tpu_torch.qa.analysis import eval_model_dir
from videocad_tpu_torch.qa.harness import QADataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--qa_dataset_path", default="data/data_raw/qa.json")
    parser.add_argument("--model_dirs", nargs="+", required=True)
    parser.add_argument("--results_path", default="res_final.json")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    dataset = QADataset(args.qa_dataset_path)
    for model_dir in args.model_dirs:
        results = eval_model_dir(model_dir, dataset, args.results_path,
                                 args.seed)
        print(f"{results['model']}: {results['overall_accuracy']:.2f}% "
              f"({results['num_correct']}/{results['num_questions']})")


if __name__ == "__main__":
    main()
