"""The training step in plain PyTorch, float32: the teacher-forcing shift,
the class-weighted tolerance loss, the gradients, a clip of their global
norm at 1.0 and Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
corrected), written out from the published recipe.

Loss: 2 * CE(command, the published command weights) + the sum over the
six parameters of a tolerance CE (a uniform target over the allowed bins
[t, t + tolerance - 1], rows whose argmax already lies there dropped), each
weighted by its command's weight. Padded steps (-1) count nowhere.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from benchmark.reference import model as ref_model
from benchmark.reference.prng import DropoutReplay, fold_in
from benchmark.reference.vocab import (CMD_WEIGHTS, NUM_PARAMS,
                                       PARAM_TO_LABEL, PARAM_TOLERANCES)

B1, B2, EPS, MAX_NORM = 0.9, 0.999, 1e-8, 1.0


def normalize(actions: torch.Tensor) -> torch.Tensor:
    """Integer actions -> model inputs: cmd / 4, params / 1000."""
    a = actions.float()
    return torch.cat([a[..., :1] / 4.0, a[..., 1:] / 1000.0], dim=-1)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / den.clamp(min=1e-20),
                       torch.zeros_like(num))


def loss_fn(cmd_logits: torch.Tensor, param_logits: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    targets = targets.long()
    weights = torch.tensor(CMD_WEIGHTS, device=cmd_logits.device)
    cmd_t = targets[..., 0].reshape(-1)
    valid = cmd_t != -1
    logp = torch.log_softmax(cmd_logits.reshape(-1, cmd_logits.shape[-1]),
                             dim=-1)
    safe = cmd_t.clamp(min=0)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = weights[safe] * valid
    total = 2.0 * _ratio((nll * w).sum(), w.sum())
    bins = param_logits.shape[-1]
    classes = torch.arange(bins, device=param_logits.device)
    for i in range(NUM_PARAMS):
        logits = param_logits[..., i, :].reshape(-1, bins)
        t = targets[..., 1 + i].reshape(-1)
        ok = t != -1
        safe = torch.where(ok, t, torch.zeros_like(t))
        lo = safe.clamp(0, bins - 1)
        hi = (safe + PARAM_TOLERANCES[i] - 1).clamp(0, bins - 1)
        pred = logits.argmax(dim=-1)
        sel = ok & ~((pred >= lo) & (pred <= hi))
        member = ((classes[None] >= lo[:, None])
                  & (classes[None] <= hi[:, None])).float()
        soft = member / member.sum(dim=1, keepdim=True).clamp(min=1.0)
        row = -(soft * torch.log_softmax(logits, dim=-1)).sum(dim=1)
        term = _ratio((row * sel).sum(), sel.sum().float())
        term = torch.where(torch.isnan(term), torch.zeros_like(term), term)
        total = total + term * CMD_WEIGHTS[PARAM_TO_LABEL[i]]
    return total


class Trainer:
    """The reference's parameters and Adam moments, stepped like the
    program's train step (the same seed rule for dropout);
    ``low_precision``: every product in fp8 (``model.LowPrecision``).
    ``forward`` is a model's plain forward with ``model.forward``'s
    signature (another family's reference; it takes or ignores ``drop``)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 lr: float, low_precision: bool = False,
                 forward: Callable = ref_model.forward):
        self.cfg = cfg
        self.lr = lr
        self.low_precision = low_precision
        self.forward = forward
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step_count = 0

    def step(self, batch: Dict[str, torch.Tensor], seed: int
             ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step on ``batch`` (frames, actions, cad_image, the raw
        padded batch); returns (loss, the norm of each clipped gradient
        that Adam got)."""
        s = ref_model.sizes(self.cfg)
        drop_seed = fold_in(fold_in(seed, self.step_count), 1)
        drop = DropoutReplay(drop_seed, s["dropout"], batch["frames"].device)
        actions = batch["actions"]
        params = (ref_model.LowPrecision(self.params) if self.low_precision
                  else self.params)
        cmd, par = self.forward(
            params, self.cfg, batch["frames"][:, :-1],
            normalize(actions)[:, :-1], batch["cad_image"], drop)
        loss = loss_fn(cmd, par, actions[:, 1:])
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        del cmd, par
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 if norm < MAX_NORM else MAX_NORM / norm.item()
        self.step_count += 1
        k = self.step_count
        clipped = {}
        with torch.no_grad():
            for name, g in zip(names, grads):
                g = g * scale
                clipped[name] = g.double().norm()
                m, v = self.m[name], self.v[name]
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                m_hat = m / (1 - B1 ** k)
                v_hat = v / (1 - B2 ** k)
                self.params[name].sub_(self.lr * m_hat / (v_hat.sqrt() + EPS))
        return float(loss.detach()), clipped
