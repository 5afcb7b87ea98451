"""Video-QA evaluation CLI (reference eval_qa.py:572-626 surface).

Port of ``videocad_tpu/cli/eval_qa.py``; host only, it takes no device.

    python -m videocad_tpu_torch.cli.eval_qa --qa_dataset_path data/qa.json \
        --model_name random --question_range 1-100
"""

from __future__ import annotations

import argparse

from videocad_tpu_torch.qa.harness import (
    EvaluationPipeline,
    QADataset,
    create_client,
)


def parse_range(range_str):
    if not range_str:
        return None
    parts = range_str.split("-")
    if len(parts) != 2:
        raise ValueError(f"Invalid question_range '{range_str}'; expected START-END")
    start = max(int(parts[0]) - 1, 0)  # 1-indexed inclusive input
    return (start, int(parts[1]))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run VQA evaluation pipeline.")
    parser.add_argument("--qa_dataset_path", default="data/data_raw/qa.json")
    parser.add_argument("--output_dir", default="data/data_raw/qa/results")
    parser.add_argument("--model_name", default="random",
                        help="comma-separated model names")
    parser.add_argument("--api_key", default=None)
    parser.add_argument("--question_range", default="",
                        help="e.g. '1-100' (1-indexed, inclusive start)")
    parser.add_argument("--mock_mode", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    question_range = parse_range(args.question_range)
    range_name = args.question_range or "all"
    dataset = QADataset(args.qa_dataset_path, question_range)
    print(f"Loaded {len(dataset)} questions (range {range_name})")

    for model_name in args.model_name.split(","):
        client = create_client(model_name.strip(), args.api_key,
                               mock_mode=args.mock_mode, seed=args.seed)
        pipeline = EvaluationPipeline(dataset, args.output_dir, client,
                                      question_range_str=range_name,
                                      seed=args.seed)
        metrics = pipeline.run()
        print(f"{model_name}: overall accuracy "
              f"{metrics['overall_accuracy']:.2f}% "
              f"({metrics['num_correct']}/{metrics['num_questions']})")


if __name__ == "__main__":
    main()
