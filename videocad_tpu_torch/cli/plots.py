"""Error-analysis plot suite.

Port of ``videocad_tpu/cli/plots.py``: numpy and matplotlib over the
first-mistake structure that ``Trainer.find_first_mistake`` returns:
confusion matrices with per-field binning specs, the sequence-length
scatter, the first-mistake histogram, the mistakes histogram and scatter,
the accuracy-vs-tolerance curves and the perfect-sequence-vs-share-given
curve. The numbers behind the plots (:func:`confusion_matrix`,
:func:`accuracy_vs_tolerance`, :func:`perfect_sequence_percentages`) need
numpy alone. matplotlib is an optional dependency (the ``plots`` extra), so
it is imported by the drawing functions, headless (Agg), never at module
import; :func:`matplotlib_available` says whether they can run.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List

import numpy as np

# (matrix dim, bin scale, annotate) per field — reference test.py:37-45
CONFUSION_SPECS = {
    "cmd": (5, 1, True),
    "param_0": (200, 5, False),
    "param_1": (200, 5, False),
    "param_2": (20, 50, True),
    "param_3": (5, 200, True),
    "param_4": (2, 500, True),
    "param_5": (200, 5, False),
}

FIELD_NAMES = ["Move to", "Press key", "Scroll", "Type", "Click",
               "x", "y", "Key Pressed", "Times Key Pressed",
               "Scroll Amount", "Type Amount"]


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def confusion_matrix(pairs: List, dim: int, scale: int = 1,
                     row_norm: bool = True) -> np.ndarray:
    matrix = np.zeros((dim, dim))
    for actual, predicted in pairs:
        a, p = int(actual) // scale, int(predicted) // scale
        if 0 <= a < dim and 0 <= p < dim:
            matrix[a, p] += 1
    if row_norm:
        denom = matrix.sum(axis=1, keepdims=True)
    else:
        denom = matrix.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, matrix / denom * 100, 0.0)


def plot_matrix(matrix: np.ndarray, filename: str, annotate: bool = True):
    plt = _pyplot()
    plt.figure(figsize=(10, 10))
    plt.imshow(matrix)
    plt.xlabel("Predicted")
    plt.ylabel("Actual")
    plt.colorbar()
    if annotate:
        for i in range(matrix.shape[0]):
            for j in range(matrix.shape[1]):
                plt.text(j, i, f"{matrix[i, j]:.1f}", ha="center", va="center")
    plt.savefig(filename)
    plt.close()


def plot_confusion_matrices(memory: Dict, plots_dir: str, name: str,
                            prefix: str = "val", row_norm: bool = True):
    for key, (dim, scale, annotate) in CONFUSION_SPECS.items():
        matrix = confusion_matrix(memory[key], dim, scale, row_norm)
        plot_matrix(matrix,
                    os.path.join(plots_dir,
                                 f"{name}_{prefix}_{key}_confusion_matrix.png"),
                    annotate=annotate)


def plot_sequence_analysis(bucket: Dict, plots_dir: str, name: str,
                           mode: str = "val"):
    plt = _pyplot()
    seq_lengths = bucket["Sequence Lengths"]
    first_mistakes = bucket["First Mistakes"]
    mistakes = bucket["Number of Mistakes"]

    actual = [x[1] for x in seq_lengths]
    predicted = [x[0] for x in seq_lengths]
    max_len = max(actual) if actual else 1

    plt.figure(figsize=(5, 5))
    plt.scatter(actual, predicted, alpha=0.1)
    plt.plot([0, max_len], [0, max_len], color="red")
    plt.ylim(0, max_len + 1)
    plt.xlabel("Actual Sequence Length")
    plt.ylabel("Predicted Sequence Length")
    plt.savefig(os.path.join(plots_dir, f"{name}_{mode}_seq_length_scatter.png"))
    plt.close()

    perfect = sum(1 for x in seq_lengths if x[0] == x[1])
    print(f"Number of perfect sequences ({mode}): {perfect}")

    counts = {k: len(v) for k, v in first_mistakes.items()}
    plt.figure(figsize=(7, 5))
    plt.bar(FIELD_NAMES, list(counts.values()))
    plt.xticks(rotation=30)
    plt.xlabel("Commands and Parameters")
    plt.ylabel("Frequency of Mistake")
    plt.tight_layout()
    plt.savefig(os.path.join(plots_dir, f"{name}_{mode}_prob_histogram.png"))
    plt.close()

    per_seq = [sum(mistakes[i]) / max(seq_lengths[i][1], 1)
               for i in range(len(seq_lengths))]
    plt.figure(figsize=(8, 5))
    plt.hist(per_seq, bins=np.linspace(0, 1, 101), edgecolor="black",
             align="left")
    plt.xlabel("Number of Mistakes per Sequence")
    plt.ylabel("Number of Sequences")
    plt.title("Histogram of Mistakes per Sequence")
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(os.path.join(plots_dir, f"{name}_{mode}_mistakes_histogram.png"))
    plt.close()

    plt.figure(figsize=(8, 5))
    plt.scatter(actual, [sum(m) for m in mistakes], alpha=0.5)
    plt.xlabel("Sequence Length")
    plt.ylabel("Number of Mistakes")
    plt.title("Mistakes as a Function of Sequence Length")
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(os.path.join(plots_dir,
                             f"{name}_{mode}_mistakes_vs_seq_length.png"))
    plt.close()


def accuracy_vs_tolerance(memory: Dict, max_tol: int = 20) -> Dict:
    """For x, y and the typed value: the share (%) of (gt, pred) pairs
    within each tolerance 0 .. max_tol - 1."""
    curves = {}
    for f in ("param_0", "param_1", "param_5"):
        pairs = memory[f]
        accs = []
        for t in range(max_tol):
            correct = sum(1 for gt, pd in pairs if abs(gt - pd) <= t)
            accs.append(correct / len(pairs) * 100 if pairs else 0.0)
        curves[f] = accs
    return curves


def plot_accuracy_vs_tolerance(data: List[Dict], plots_dir: str, name: str,
                               max_tol: int = 20, mode: str = "val"):
    plt = _pyplot()
    plt.figure(figsize=(10, 6))
    for f, accs in accuracy_vs_tolerance(data[-1]["Memory"],
                                         max_tol).items():
        plt.plot(list(range(max_tol)), accs, label=f)
    plt.xlabel("Tolerance")
    plt.ylabel("Accuracy (%)")
    plt.title(f"Feature Accuracy vs Tolerance ({mode})")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout()
    plt.savefig(os.path.join(plots_dir,
                             f"{name}_{mode}_accuracy_vs_tolerance.png"))
    plt.close()


def perfect_sequence_percentages(bucket: Dict) -> List[float]:
    """For each share 0 .. 100% of a sequence given: the share (%) of
    sequences with no mistake in the rest."""
    num_mistakes = bucket["Number of Mistakes"]
    seq_lengths = bucket["Sequence Lengths"]
    fractions = []
    total = max(len(seq_lengths), 1)
    for p in range(101):
        frac = p / 100.0
        perfect = 0
        for i in range(len(seq_lengths)):
            start = int(frac * seq_lengths[i][1])
            if sum(num_mistakes[i][start:]) == 0:
                perfect += 1
        fractions.append(perfect / total * 100)
    return fractions


def plot_perfect_sequence_percentage(data: List[Dict], plots_dir: str,
                                     name: str, mode: str = "val"):
    plt = _pyplot()
    percentages = list(range(101))
    fractions = perfect_sequence_percentages(data[-1])
    plt.figure(figsize=(8, 5))
    plt.plot(percentages, fractions, marker="o")
    plt.xlabel("Percentage of Sequence Given (%)")
    plt.ylabel("Perfect Sequences (%)")
    plt.title(f"Perfect Sequence Rate vs Percentage Given ({mode})")
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(os.path.join(plots_dir,
                             f"{name}_{mode}_perfect_sequence_vs_given.png"))
    plt.close()


def run_plot_suite(data: List[Dict], plots_dir: str, name: str,
                   mode: str = "val"):
    """All plots for one split from one find_first_mistake result."""
    os.makedirs(plots_dir, exist_ok=True)
    plot_sequence_analysis(data[-1], plots_dir, name, mode)
    plot_confusion_matrices(data[-1]["Memory"], plots_dir, name, prefix=mode)
    plot_accuracy_vs_tolerance(data, plots_dir, name, mode=mode)
    plot_perfect_sequence_percentage(data, plots_dir, name, mode=mode)
