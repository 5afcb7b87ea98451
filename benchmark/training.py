"""What the training cells share: the model family a cell's configuration
names (``benchmark/families/<family>.py``: the program, its weights, its
reference and its work a step), the readings taken from the program during
its first steps, and their comparison with the reference's steps.

The numbers compared (each the worst case over what it covers):

  loss_gap    |program loss - reference loss| / |reference loss|, steps 1-3
  grad_gap    per leaf, |norm of the program's first clipped gradient
              (Adam's first moment after step 1, / (1 - b1)) - the
              reference's| / max(reference's norm of the leaf, of the
              median leaf)
  update_gap  the same of each leaf's change over steps 1-3, leaving out
              leaves whose first reference gradient is under a thousandth
              of the median leaf's (their moves are round-off under Adam)
  grad_gap_median  the median leaf's grad_gap
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.harness import Context
from benchmark.kernels import k1
from benchmark.reference.train import B1

SMALL_GRAD = 1e-3


def step_work(fam, cfg: Dict, batch: int, t: int) -> Dict[str, float]:
    """The model FLOPs of a train step over (B, T) inputs and, where the
    family calls K1, the least time its calls take."""
    out = {"flops_per_step": fam.train_step_flops(cfg, batch, t)}
    calls = fam.k1_calls(cfg, batch, t)
    if calls:
        out["k1_bound_per_step"] = k1.calls_bound_s(calls)
    return out


class ProgramReadings:
    """The program's numbers from its first steps: each loss, the first
    gradient as Adam holds it, and each leaf's change after step 3."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self.names: List[str] = list(weights)
        self.losses: List[torch.Tensor] = []
        self.grad_norms = None
        self.update_norms = None

    def after_step(self, state, loss: torch.Tensor,
                   weights: Dict[str, torch.Tensor]) -> None:
        self.losses.append(loss.detach().float())
        opt = state.opt_state
        if len(self.losses) == 1:
            # No moment where the step left the optimizer untouched.
            self.grad_norms = torch.stack([
                (opt.state[state.params[n]]["exp_avg"].double() / (1 - B1))
                .norm() if "exp_avg" in opt.state[state.params[n]]
                else torch.zeros((), dtype=torch.float64)
                for n in self.names])
        if len(self.losses) == 3:
            self.update_norms = torch.stack([
                (state.params[n].detach().double() - weights[n].double())
                .norm() for n in self.names])


def leaf_gaps(program: torch.Tensor, reference: torch.Tensor,
              keep: torch.Tensor = None) -> torch.Tensor:
    """Each leaf's |program - reference| / max(reference, median leaf)."""
    if keep is not None:
        program, reference = program[keep], reference[keep]
    floor = reference.median()
    return (program - reference).abs() / torch.maximum(reference, floor)


def reference_readings(ctx: Context, fam, batches: List[Dict],
                       weights: Dict[str, torch.Tensor], names: List[str],
                       low_precision: bool = False):
    """The family's reference's three steps on ``batches``: each loss, the
    first clipped gradient's norm and each leaf's change, by leaf; in fp8
    with ``low_precision`` (the control)."""
    trainer = fam.reference_trainer(ctx, weights, low_precision)
    losses, grads = [], None
    for batch in batches[:3]:
        loss, norms = trainer.step(batch, ctx.seed)
        losses.append(loss)
        if grads is None:
            grads = torch.stack([norms[n] for n in names])
    with torch.no_grad():
        updates = torch.stack([
            (trainer.params[n].double() - weights[n].double()).norm()
            for n in names])
    return losses, grads, updates


def compare(ctx: Context, fam, readings: ProgramReadings,
            batches: List[Dict], weights: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """Run the reference's first three steps on ``batches``; the numbers
    that compare the program with it (with the cell's ``control`` set to
    "fp8_reference", the reference computed in fp8 takes the program's
    place)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = readings.names
    losses, grads, updates = reference_readings(ctx, fam, batches, weights,
                                                names)
    if ctx.params.get("control") == "fp8_reference":
        got_losses, got_grads, got_updates = reference_readings(
            ctx, fam, batches, weights, names, low_precision=True)
    else:
        got_losses = [float(x) for x in readings.losses[:3]]
        got_grads = readings.grad_norms.to(grads.device)
        got_updates = readings.update_norms.to(grads.device)
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(got_losses, losses)]
    moved = grads >= SMALL_GRAD * grads.median()
    grad_gaps = leaf_gaps(got_grads, grads)
    update_gaps = leaf_gaps(got_updates, updates, moved)
    return {"loss_gap": max(loss_gaps),
            "grad_gap": float(grad_gaps.max()),
            "grad_gap_median": float(grad_gaps.median()),
            "update_gap": float(update_gaps.max())}

