"""Metric accumulation and derived percentages.

Port of ``videocad_tpu/train/metrics.py``, host side: the raw counters of
``train/objective.py`` accumulate across batches and the percentage fields
derive from them. The key names match the reference trainer's log files.
``float(counter)`` reads a device scalar, so accumulate once per logging
interval, not every step.
"""

from __future__ import annotations

from typing import Dict

from videocad_tpu_torch.actions.vocab import NUM_COMMANDS, NUM_PARAMS

_COUNTER_KEYS = (
    ["correct_predictions", "total_predictions",
     "cmd_correct_topk", "param_correct_topk",
     "cmd_counts_topk", "param_counts_topk",
     "perfect_sequences", "perfect_commands", "total_sequences"]
    + [f"param_corrects_{i}" for i in range(NUM_PARAMS)]
    + [f"param_counts_{i}" for i in range(NUM_PARAMS)]
    + [f"cmd_corrects_{i}" for i in range(NUM_COMMANDS)]
    + [f"cmd_counts_{i}" for i in range(NUM_COMMANDS)]
)


def init_metrics() -> Dict[str, float]:
    metrics = {key: 0.0 for key in _COUNTER_KEYS}
    metrics.update({
        "cmd_accuracy": 0.0, "params_accuracy": 0.0,
        "cmd_accuracy_topk": 0.0, "param_accuracy_topk": 0.0,
        "perfect_command_accuracy": 0.0, "perfect_sequence_accuracy": 0.0,
        "cmd_corrects": 0.0, "cmd_counts": 0.0,
        "param_corrects": 0.0, "param_counts": 0.0,
    })
    for i in range(NUM_PARAMS):
        metrics[f"param_accuracy_{i}"] = 0.0
    for i in range(NUM_COMMANDS):
        metrics[f"cmd_accuracy_{i}"] = 0.0
    return metrics


def update_metrics(metrics: Dict[str, float], batch_metrics: Dict) -> Dict[str, float]:
    """Accumulate one batch's counters and refresh derived percentages."""
    for key in _COUNTER_KEYS:
        if key in batch_metrics:
            metrics[key] += float(batch_metrics[key])

    if metrics["cmd_counts_topk"] > 0:
        metrics["cmd_accuracy_topk"] = 100 * metrics["cmd_correct_topk"] / metrics["cmd_counts_topk"]
    if metrics["param_counts_topk"] > 0:
        metrics["param_accuracy_topk"] = 100 * metrics["param_correct_topk"] / metrics["param_counts_topk"]

    for i in range(NUM_PARAMS):
        if metrics[f"param_counts_{i}"] > 0:
            metrics[f"param_accuracy_{i}"] = (
                100 * metrics[f"param_corrects_{i}"] / metrics[f"param_counts_{i}"])
    for i in range(NUM_COMMANDS):
        if metrics[f"cmd_counts_{i}"] > 0:
            metrics[f"cmd_accuracy_{i}"] = (
                100 * metrics[f"cmd_corrects_{i}"] / metrics[f"cmd_counts_{i}"])

    total_cmd = sum(metrics[f"cmd_counts_{i}"] for i in range(NUM_COMMANDS))
    total_param = sum(metrics[f"param_counts_{i}"] for i in range(NUM_PARAMS))
    if total_cmd > 0:
        metrics["cmd_accuracy"] = (
            100 * sum(metrics[f"cmd_corrects_{i}"] for i in range(NUM_COMMANDS)) / total_cmd)
    if total_param > 0:
        metrics["params_accuracy"] = (
            100 * sum(metrics[f"param_corrects_{i}"] for i in range(NUM_PARAMS)) / total_param)
    if metrics["total_predictions"] > 0:
        metrics["overall_accuracy"] = (
            100 * metrics["correct_predictions"] / metrics["total_predictions"])
    if metrics["total_sequences"] > 0:
        metrics["perfect_sequence_accuracy"] = (
            100 * metrics["perfect_sequences"] / metrics["total_sequences"])
        metrics["perfect_command_accuracy"] = (
            100 * metrics["perfect_commands"] / metrics["total_sequences"])
    return metrics
