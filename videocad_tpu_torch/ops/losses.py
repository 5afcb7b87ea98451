"""Loss functions: class-weighted CE and tolerance-aware "flexible" CE.

Port of ``videocad_tpu/ops/losses.py``, with its formulation kept:

* no boolean indexing: ignored and in-tolerance rows are masked out with
  weights, so every shape is static (a boolean index would also force a
  device synchronisation in PyTorch);
* the tolerance soft target is a uniform distribution over the integer
  interval [lo, hi], so interval membership is computed analytically.

Parity quirk kept by default: the flexible CE runs in one-sided ("above")
mode for every parameter, while the accuracy counters use the per-param
flag (``train/objective.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           ignore_index: int = -1) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight=w, ignore_index=-1) semantics:
    sum_i w[t_i] * nll_i / sum_i w[t_i] over non-ignored rows, and 0.0
    when every row is ignored.

    logits: (..., C); targets: (...,) int.
    """
    num, total_w = weighted_cross_entropy_terms(logits, targets,
                                                class_weights, ignore_index)
    return torch.where(total_w > 0, num / total_w.clamp(min=1e-20), 0.0)


def weighted_cross_entropy_terms(logits: torch.Tensor, targets: torch.Tensor,
                                 class_weights: Optional[torch.Tensor] = None,
                                 ignore_index: int = -1
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The numerator ``sum_i w[t_i] * nll_i`` and the denominator
    ``sum_i w[t_i]`` of :func:`weighted_cross_entropy`, which the
    data-parallel objective reduces over its ranks apart.

    Targets index as JAX indexes: a negative one counts from the end, and
    one outside [-C, C) gives a NaN nll, as JAX's ``take_along_axis``
    does, so the objective's NaN guard drops that loss; its bin weight is
    the nearest bin's (JAX clamps an index). Both are ``torch.where`` on a
    clamped index: no out-of-bounds gather (an error on the CPU, a
    device-side assert on the card) and no host synchronisation.
    """
    num_classes = logits.shape[-1]
    logits = logits.reshape(-1, num_classes)
    targets = targets.reshape(-1)
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0)
    index = torch.where(safe_targets < 0, safe_targets + num_classes,
                        safe_targets)
    in_range = (index >= 0) & (index < num_classes)

    log_probs = _log_softmax(logits)
    picked = log_probs.gather(1, index.clamp(0, num_classes - 1)[:, None])
    nll = torch.where(in_range, -picked[:, 0], torch.nan)

    if class_weights is not None:
        n_w = class_weights.shape[0]
        w_index = torch.where(safe_targets < 0, safe_targets + n_w,
                              safe_targets).clamp(0, n_w - 1)
        w = class_weights[w_index] * valid
    else:
        w = valid.to(logits.dtype)
    return (nll * w).sum(), w.sum()


def tolerance_interval(targets: torch.Tensor, tolerance: int, above: bool,
                       num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The clamped allowed-class interval [lo, hi] for each target.

    above: [t, min(t + tol - 1, C - 1)]; else: [max(t - tol, 0),
    min(t + tol, C - 1)].
    """
    if above:
        lo = targets.clamp(0, num_classes - 1)
        hi = (targets + tolerance - 1).clamp(0, num_classes - 1)
    else:
        lo = (targets - tolerance).clamp(0, num_classes - 1)
        hi = (targets + tolerance).clamp(0, num_classes - 1)
    return lo, hi


def flexible_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           tolerance: int = 2, ignore_index: int = -1,
                           above: bool = True, ignore_valid: bool = True,
                           class_weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Tolerance-aware CE with a uniform soft target over the allowed
    window: rows whose target is ``ignore_index`` are dropped; with
    ``ignore_valid``, rows whose argmax already falls in the window are
    dropped too; the rest get CE against the uniform distribution over the
    window; mean over the remaining rows, 0.0 when none remain.
    """
    total, n_sel = flexible_cross_entropy_terms(
        logits, targets, tolerance, ignore_index, above, ignore_valid,
        class_weights)
    return torch.where(n_sel > 0, total / n_sel.clamp(min=1), 0.0)


def flexible_cross_entropy_terms(logits: torch.Tensor, targets: torch.Tensor,
                                 tolerance: int = 2, ignore_index: int = -1,
                                 above: bool = True,
                                 ignore_valid: bool = True,
                                 class_weights: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed row losses and the count of rows that remain, of
    :func:`flexible_cross_entropy`."""
    num_classes = logits.shape[-1]
    logits = logits.reshape(-1, num_classes).to(torch.float32)
    targets = targets.reshape(-1)

    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0)
    lo, hi = tolerance_interval(safe_targets, tolerance, above, num_classes)

    preds = logits.argmax(dim=-1)
    in_window = (preds >= lo) & (preds <= hi)
    sel = valid & ~in_window if ignore_valid else valid

    classes = torch.arange(num_classes, device=logits.device)
    membership = ((classes[None, :] >= lo[:, None])
                  & (classes[None, :] <= hi[:, None]))
    soft = membership.to(torch.float32)
    soft = soft / soft.sum(dim=1, keepdim=True).clamp(min=1.0)

    log_probs = _log_softmax(logits)
    if class_weights is not None and class_weights.shape[0] == num_classes:
        log_probs = log_probs * class_weights[safe_targets][:, None]
    row_loss = -(soft * log_probs).sum(dim=1)

    return (row_loss * sel).sum(), sel.sum()
