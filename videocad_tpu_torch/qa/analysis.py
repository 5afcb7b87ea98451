"""Majority-vote aggregation over repeated QA runs.

Port of ``videocad_tpu/qa/analysis.py`` (standard library only), a
re-design of the reference qa_analysis.py: collect every model_results*
file in a model's output directory, substitute random options for
unknown-answer records, group outputs per question, majority-vote (dropping
one least-common answer when the count is even; questions with < 3 votes
are excluded), and aggregate per-template accuracy. Results append to
``res_final.json``.
"""

from __future__ import annotations

import json
import os
import random
from collections import Counter
from typing import Dict, List, Optional

from videocad_tpu_torch.qa.harness import QADataset, UNKNOWN_ANSWER_CODE


def load_all_outputs(model_dir: str, dataset: QADataset,
                     rng: Optional[random.Random] = None) -> List[Dict]:
    """All 'results' files in a model directory, unknowns randomized."""
    rng = rng or random.Random(0)
    outputs: List[Dict] = []
    for name in sorted(os.listdir(model_dir)):
        if "results" not in name:
            continue
        with open(os.path.join(model_dir, name)) as f:
            outputs.extend(json.load(f))
    for out in outputs:
        item = dataset.by_id.get(out["question_id"])
        if item is not None:
            out["template"] = item.template
        if out.get("answer") == UNKNOWN_ANSWER_CODE and item is not None:
            out["answer"] = rng.choice(item.option_ids)
    return outputs


def group_outputs(outputs: List[Dict], start_q: int, end_q: int,
                  rng: Optional[random.Random] = None) -> Dict[int, List[Dict]]:
    """Per-question groups ready for voting.

    Groups with < 3 votes are dropped; even-sized groups (>= 4) shed one
    instance of the least common answer so the vote has a strict mode.
    """
    rng = rng or random.Random(0)
    by_question: Dict[int, List[Dict]] = {}
    for out in outputs:
        q_id = out["question_id"]
        if start_q <= q_id <= end_q:
            by_question.setdefault(q_id, []).append(out)

    valid: Dict[int, List[Dict]] = {}
    for q_id, group in by_question.items():
        if len(group) < 3:
            continue
        if len(group) % 2 == 0:
            counts = Counter(o["answer"] for o in group)
            least = min(counts.values())
            drop = rng.choice([a for a, c in counts.items() if c == least])
            for i, o in enumerate(group):
                if o["answer"] == drop:
                    group = group[:i] + group[i + 1:]
                    break
        valid[q_id] = group
    return valid


def majority_vote_accuracy(dataset: QADataset, outputs: List[Dict],
                           start_q: int = 0, end_q: int = 1200,
                           rng: Optional[random.Random] = None) -> Dict:
    groups = group_outputs(outputs, start_q, end_q, rng)
    per_template: Dict[str, Dict[str, int]] = {}
    for q_id, group in groups.items():
        item = dataset.get(q_id)
        stats = per_template.setdefault(item.template,
                                        {"correct": 0, "total": 0})
        mode_answer, _ = Counter(o["answer"] for o in group).most_common(1)[0]
        stats["total"] += 1
        if mode_answer == item.answer:
            stats["correct"] += 1

    results: Dict = {
        template: {
            "correct": s["correct"],
            "total": s["total"],
            "accuracy": s["correct"] / s["total"] if s["total"] else 0.0,
        }
        for template, s in per_template.items()
    }
    total = sum(s["total"] for s in per_template.values())
    correct = sum(s["correct"] for s in per_template.values())
    results["overall_accuracy"] = correct / total * 100 if total else 0.0
    results["num_questions"] = total
    results["num_correct"] = correct
    return results


def eval_model_dir(model_dir: str, dataset: QADataset,
                   results_path: str = "res_final.json",
                   seed: int = 0) -> Dict:
    """Aggregate one model's runs and append to the cumulative results file."""
    rng = random.Random(seed)
    outputs = load_all_outputs(model_dir, dataset, rng)
    results = majority_vote_accuracy(dataset, outputs, rng=rng)
    results["model"] = os.path.basename(model_dir.rstrip("/"))

    existing = []
    if os.path.exists(results_path):
        try:
            with open(results_path) as f:
                existing = json.load(f)
            if not isinstance(existing, list):
                existing = [existing]
        except json.JSONDecodeError:
            existing = []
    existing.append(results)
    with open(results_path, "w") as f:
        json.dump(existing, f, indent=4)
    return results
