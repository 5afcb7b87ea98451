"""Training state and optimizer construction.

Port of ``videocad_tpu/train/state.py``: Adam with global-norm gradient
clipping at 1.0, optional per-component learning rates (CAD encoder /
state encoder / rest) when ``frozen``, and a CAD encoder that gets no
update when ``freeze_cad``.

Where the JAX state is an immutable tree that each step replaces, the
port's parameters are the model's own ``nn.Parameter``s and the optimizer
updates them in place (no second copy of the weights in device memory);
:class:`TrainState` names them and counts the steps. The sharded state
comes with the parallel slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

import torch
from torch import nn

MAX_GRAD_NORM = 1.0


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: gradients are untouched
    while their global L2 norm is below ``max_norm`` and scaled by
    ``max_norm / norm`` otherwise. (``torch.nn.utils.clip_grad_norm_``
    scales by ``max_norm / (norm + 1e-6)``, another rule.) Everything stays
    on the device: no ``.item()``. Returns the norm."""
    norms = torch._foreach_norm(grads)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    params: Dict[str, nn.Parameter]   # the model's own, updated in place
    opt_state: torch.optim.Adam       # its moments and step counts

    def apply_gradients(self) -> "TrainState":
        """``optax.chain(clip_by_global_norm(1.0), adam)`` over the
        gradients that ``backward`` left on the parameters: the clip sees
        every parameter's gradient, Adam those of the groups it holds."""
        grads = [p.grad for p in self.params.values() if p.grad is not None]
        if grads:
            clip_by_global_norm_(grads)
        self.opt_state.step()
        return dataclasses.replace(self, step=self.step + 1)


def _param_group(path_names: Iterable[str]) -> str:
    path_names = list(path_names)
    if "cad_encoder" in path_names:
        return "cad"
    if "state_encoder" in path_names:
        return "state"
    return "rest"


def make_optimizer(params: Dict[str, nn.Parameter], training_config: Dict,
                   freeze_cad: bool = False) -> torch.optim.Adam:
    """Build Adam per the reference's setup (the clip is
    ``TrainState.apply_gradients``'s). ``params`` maps the
    model's parameter names (``dict(model.named_parameters())``) to the
    parameters. optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
    root, bias-corrected) is ``torch.optim.Adam``'s default."""
    lr = training_config.get("lr", 1e-3)
    frozen = training_config.get("frozen", False)
    lrs = {"cad": lr, "state": lr, "rest": lr}
    if frozen or freeze_cad:
        lrs["cad"] = 0.0 if freeze_cad else training_config.get("lr_cad",
                                                                1e-3)
        lrs["state"] = training_config.get("lr_state", 1e-3) if frozen else lr
    groups: Dict[str, List[nn.Parameter]] = {"cad": [], "state": [],
                                             "rest": []}
    for name, param in params.items():
        groups[_param_group(name.split("."))].append(param)
    # A group at learning rate 0 gets no update and keeps no moments
    # (optax.set_to_zero).
    return torch.optim.Adam([{"params": members, "lr": lrs[group]}
                             for group, members in groups.items()
                             if members and lrs[group] > 0])


def create_train_state(params: Dict[str, nn.Parameter],
                       training_config: Dict,
                       freeze_cad: bool = False) -> TrainState:
    """The state for ``dict(model.named_parameters())``. Where the JAX
    package returns the optax transform beside the state, the optimizer
    here lives in the state."""
    return TrainState(step=0, params=params, opt_state=make_optimizer(
        params, training_config, freeze_cad))
