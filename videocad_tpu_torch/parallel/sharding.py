"""Parameter partitioning over the ``model`` axis (tensor parallelism).

Port of ``videocad_tpu/parallel/sharding.py``: the same rule table on the
port's parameter names. A flax ``kernel`` (in, out) is a torch ``weight``
(out, in), so a column split shards ``weight`` dim 0 and the ``bias``, and
a row split shards ``weight`` dim 1:

  * attention query / key / value  -> column (the heads)
  * attention out                  -> row
  * linear1 / mlp_in               -> column (the FFN / MLP width)
  * linear2 / mlp_out              -> row
  * predict_params                 -> column (6 x 1000 logits)

:func:`param_pspec` is that table, a spec of one entry a dim as in JAX's
``PartitionSpec``, and :func:`shard_model` splits by it. Where the layout
differs from JAX's: GSPMD shards any dim that divides and repartitions
around it, while the port computes on its shards and places the
collectives itself (``parallel/collectives.py``, ``models/layers.py``). So
the :class:`Dense` children of one module that the table splits form a
unit, split Megatron-style only as a whole: an attention's projections
only when its heads divide by ``model``, an FFN pair only when its width
does, the parameter head only when its columns do. Otherwise the unit
stays replicated, which computes the same numbers. A unit with columns
and no row (the parameter head) has its output gathered. A sharded
parameter carries its dim as ``param.tp_dim`` and its group as
``param.tp_group``, and :func:`param_shardings` reads the live layout back.

:func:`shard_params` slices a full (single-card) state dict to this rank's
shards, and :func:`gather_params` is its inverse: for checkpoints and the
rollout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from videocad_tpu_torch.models.layers import Dense, MultiHeadAttention
from videocad_tpu_torch.parallel.collectives import (gather_tensor,
                                                     shard_tensor)
from videocad_tpu_torch.parallel.mesh import MODEL_AXIS

_COLUMN_SPLIT_MODULES = ("query", "key", "value", "linear1", "mlp_in",
                         "predict_params")
_ROW_SPLIT_MODULES = ("out", "linear2", "mlp_out")

Spec = Tuple[Optional[str], ...]


def param_pspec(name: str) -> Spec:
    """The rule table's spec for one parameter of the port, by its dotted
    name: one entry a dim of the torch tensor, ``"model"`` where that dim
    is split."""
    parts = name.split(".")
    if len(parts) < 2:
        return ()
    module, param = parts[-2], parts[-1]
    column = module in _COLUMN_SPLIT_MODULES
    if param == "weight":
        if column:
            return (MODEL_AXIS, None)
        if module in _ROW_SPLIT_MODULES:
            return (None, MODEL_AXIS)
    elif param == "bias" and column:
        return (MODEL_AXIS,)
    return ()


def _table_mode(name: str) -> Optional[str]:
    """``"column"``, ``"row"`` or None: how the rule table splits the
    :class:`Dense` of dotted name ``name``."""
    return {(MODEL_AXIS, None): "column",
            (None, MODEL_AXIS): "row"}.get(param_pspec(f"{name}.weight"))


def _shard_dense(dense: Dense, mode: str, mesh) -> None:
    """Replace ``dense``'s parameters by this rank's shards and set its
    collectives: ``"column"`` (output features split, the input copied into
    the model region), ``"heads"`` (a column whose attention copies its
    input), ``"row"`` (input features split, partial sums reduced, the bias
    added once after) or ``"gather"`` (column, the output joined again)."""
    size, rank = mesh.model_size, mesh.model_rank
    dim = 1 if mode == "row" else 0
    with torch.no_grad():
        weight = nn.Parameter(shard_tensor(dense.weight, dim, rank, size))
        weight.tp_dim, weight.tp_group = dim, mesh.model_group
        dense.weight = weight
        if dense.bias is not None and mode != "row":
            bias = nn.Parameter(shard_tensor(dense.bias, 0, rank, size))
            bias.tp_dim, bias.tp_group = 0, mesh.model_group
            dense.bias = bias
    dense.tp_mode = mode
    dense.tp_group = mesh.model_group


def shard_model(model: nn.Module, mesh) -> Dict[str, Spec]:
    """Split ``model``'s modules over the mesh's model axis by
    :func:`param_pspec`, in place (their parameters become this rank's
    shards), and return the live layout. Call it before the optimizer and
    DDP take the parameters. A mesh with one model rank leaves the model as
    it is."""
    if mesh is None or mesh.model_size == 1:
        return param_shardings(model)
    size = mesh.model_size
    for name, module in list(model.named_modules()):
        unit = {}
        for child, dense in module.named_children():
            mode = (_table_mode(f"{name}.{child}" if name else child)
                    if isinstance(dense, Dense) and dense.tp_mode is None
                    else None)
            if mode is not None:
                unit[dense] = mode
        columns = [dense for dense, mode in unit.items() if mode == "column"]
        attention = isinstance(module, MultiHeadAttention)
        if attention:
            fits = module.num_heads % size == 0
        else:
            fits = all(dense.weight.shape[0] % size == 0 for dense in columns)
        if not columns or not fits:
            continue
        rowless = "row" not in unit.values()
        for dense, mode in unit.items():
            if mode == "column" and (attention or rowless):
                mode = "heads" if attention else "gather"
            _shard_dense(dense, mode, mesh)
        if attention:
            module.num_heads //= size
            module.sharded = True
    return param_shardings(model)


def param_shardings(model: nn.Module) -> Dict[str, Spec]:
    """The live layout: each parameter's spec (``()`` when replicated)."""
    out = {}
    for name, p in model.named_parameters():
        dim = getattr(p, "tp_dim", None)
        out[name] = (() if dim is None else
                     tuple(MODEL_AXIS if i == dim else None
                           for i in range(p.dim())))
    return out


def split_dims(params: Mapping[str, torch.Tensor]
               ) -> Dict[str, Optional[int]]:
    """Each parameter's split dim (None: replicated)."""
    return {k: getattr(p, "tp_dim", None) for k, p in params.items()}


def shard_params(full: Mapping[str, torch.Tensor],
                 params: Mapping[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """A full (single-card) state dict sliced to this rank's shards of the
    sharded ``params`` (a model's ``named_parameters``)."""
    return shard_like(full, split_dims(params), mesh)


def gather_params(params: Mapping[str, torch.Tensor], mesh
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors of a sharded model's ``named_parameters``. Every
    rank of the model group must call it."""
    return gather_like(params, split_dims(params), mesh)


def shard_like(tensors: Mapping[str, torch.Tensor],
               dims: Mapping[str, Optional[int]], mesh
               ) -> Dict[str, torch.Tensor]:
    """Each full tensor sliced to this rank's shard along its dim in
    ``dims`` (None: replicated, kept as it is); no communication."""
    return {k: (t if mesh is None or dims.get(k) is None
                else shard_tensor(t, dims[k], mesh.model_rank,
                                  mesh.model_size))
            for k, t in tensors.items()}


def gather_like(tensors: Mapping[str, torch.Tensor],
                dims: Mapping[str, Optional[int]], mesh
                ) -> Dict[str, torch.Tensor]:
    """Each tensor gathered along its dim in ``dims`` over the model group
    (None: replicated, kept as it is); tensors laid out like the
    parameters, such as Adam's moments."""
    group = None if mesh is None else mesh.model_group
    return {k: (t.detach() if dims.get(k) is None
                else gather_tensor(t, dims[k], group))
            for k, t in tensors.items()}
