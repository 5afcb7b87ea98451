"""Training state and optimizer construction.

Port of ``videocad_tpu/train/state.py``: Adam with global-norm gradient
clipping at 1.0, optional per-component learning rates (CAD encoder /
state encoder / rest) when ``frozen``, and a CAD encoder that gets no
update when ``freeze_cad``.

Where the JAX state is an immutable tree that each step replaces, the
port's parameters are the model's own ``nn.Parameter``s and the optimizer
updates them in place (no second copy of the weights in device memory);
:class:`TrainState` names them and counts the steps.

:func:`create_sharded_train_state` is the state of a model split over a
mesh's model axis (``parallel/sharding.py:shard_model``): Adam over this
rank's shards, which is the full Adam sliced, since Adam acts entry by
entry. The clip must see the global norm, or each model rank would clip
by another factor: the squares of the split parameters' gradients are
summed over the model group, and the replicated ones (equal on every model
rank) are counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional

import torch
from torch import nn

from videocad_tpu_torch.parallel.collectives import all_reduce
from videocad_tpu_torch.utils.trace import span

MAX_GRAD_NORM = 1.0


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float = MAX_GRAD_NORM,
                         split: Optional[List[bool]] = None,
                         model_group=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: gradients are untouched
    while their global L2 norm is below ``max_norm`` and scaled by
    ``max_norm / norm`` otherwise. (``torch.nn.utils.clip_grad_norm_``
    scales by ``max_norm / (norm + 1e-6)``, another rule.) Everything stays
    on the device: no ``.item()``. Returns the norm.

    ``split`` flags the gradients of parameters split over
    ``model_group``: their squares are summed over the group, the others
    counted once."""
    norms = torch._foreach_norm(grads)
    if model_group is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        def sum_of_squares(part):
            return (torch.stack(part).square().sum() if part
                    else norms[0].new_zeros(()))
        split_sq = all_reduce(sum_of_squares(
            [n for n, s in zip(norms, split) if s]), model_group)
        norm = torch.sqrt(sum_of_squares(
            [n for n, s in zip(norms, split) if not s]) + split_sq)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    params: Dict[str, nn.Parameter]   # the model's own, updated in place
    opt_state: torch.optim.Adam       # its moments and step counts
    # the parameters split over the model group, when it has several ranks
    split: FrozenSet[str] = frozenset()
    model_group: object = None

    def apply_gradients(self) -> "TrainState":
        """``optax.chain(clip_by_global_norm(1.0), adam)`` over the
        gradients that ``backward`` left on the parameters: the clip sees
        every parameter's gradient, Adam those of the groups it holds."""
        with span("step.optimizer", self.step):
            named = [(k, p.grad) for k, p in self.params.items()
                     if p.grad is not None]
            if named:
                clip_by_global_norm_([g for _, g in named],
                                     split=[k in self.split
                                            for k, _ in named],
                                     model_group=self.model_group)
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


def create_sharded_train_state(params: Dict[str, nn.Parameter],
                               training_config: Dict, mesh,
                               freeze_cad: bool = False) -> TrainState:
    """The state for the parameters of a model that
    ``parallel/sharding.py:shard_model`` has split over ``mesh``: Adam over
    the local shards with the component learning rates of
    :func:`make_optimizer`, and the clip over the global norm."""
    state = create_train_state(params, training_config, freeze_cad)
    if mesh is None or mesh.model_size == 1:
        return state
    split = frozenset(k for k, p in params.items()
                      if getattr(p, "tp_dim", None) is not None)
    return dataclasses.replace(state, split=split,
                               model_group=mesh.model_group)
