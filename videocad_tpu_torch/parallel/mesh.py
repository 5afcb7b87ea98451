"""The rank grid of SPMD training on ``torch.distributed``.

Port of ``videocad_tpu/parallel/mesh.py``. Where JAX lays a ``Mesh`` over
devices and lets GSPMD place the collectives, the port lays the same grid
over processes (one rank a process, ``parallel/distributed.py``) and makes
a process group for each reduction:

  * ``data``: the batch's rows. The gradients and the loss denominators
    reduce over it (``train/steps.py``, ``train/objective.py``);
  * ``model``: tensor parallelism over attention heads, FFN / MLP width
    and the parameter head's columns (``parallel/sharding.py``);
  * ``dcn``: a leading data axis for multi-slice layouts
    (:func:`create_hybrid_mesh`). The batch shards over ("dcn", "data")
    jointly, and so does the data reduction.

Rank i sits where JAX puts device i: ``arange(n).reshape(data, model)`` or
``(dcn, data, model)``, so a model group holds adjacent ranks. Unlike JAX,
which may take a subset of its devices, the grid must cover the world: a
rank outside every group would wait on collectives forever.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from videocad_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


def mesh_grid(n: int, data: Optional[int] = None, model: int = 1,
              dcn: Optional[int] = None) -> np.ndarray:
    """The grid of ``n`` ranks: (data, model), or (dcn, data, model) when
    ``dcn`` is given. ``data=None`` takes what is left of ``n``. Raises,
    naming both numbers, when the axes do not multiply to ``n``."""
    lead = 1 if dcn is None else dcn
    if data is None:
        if n % (lead * model):
            raise ValueError(f"{n} ranks do not divide by model={model}"
                             + ("" if dcn is None else f" x dcn={dcn}"))
        data = n // (lead * model)
    if lead * data * model != n:
        what = (f"data={data} x model={model}" if dcn is None
                else f"dcn={dcn} x data={data} x model={model}")
        raise ValueError(f"the mesh {what} needs {lead * data * model} "
                         f"ranks, but the world has {n} (WORLD_SIZE)")
    shape = (data, model) if dcn is None else (dcn, data, model)
    return np.arange(n).reshape(shape)


def _new_groups(rows: np.ndarray, rank: int):
    """One process group for each row of ``rows`` (made on every rank, in
    one order, as ``new_group`` requires); returns this rank's."""
    mine = None
    for row in rows:
        group = dist.new_group([int(r) for r in row])
        if rank in row:
            mine = group
    return mine


@dataclasses.dataclass
class Mesh:
    """The grid, this rank's place in it and its process groups (None with
    one process)."""

    axis_names: Tuple[str, ...]
    grid: np.ndarray
    rank: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def model_size(self) -> int:
        return self.grid.shape[-1]

    @property
    def data_size(self) -> int:
        """Ranks along the batch: data, times dcn on a hybrid mesh."""
        return self.grid.size // self.model_size

    def _coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.argwhere(self.grid == self.rank)[0])

    @property
    def model_rank(self) -> int:
        return self._coords()[-1]

    @property
    def data_rank(self) -> int:
        """This rank's place along ("dcn", "data") jointly."""
        return self.rank // self.model_size

    @property
    def world_group(self):
        return dist.group.WORLD if dist.is_initialized() else None

    def rows(self, batch_size: int) -> slice:
        """The rows of a global batch that this rank holds:
        ``[r * B / dp, (r + 1) * B / dp)`` of its data rank r (the
        counterpart of ``batch_sharding`` / ``put_local_shard``)."""
        if batch_size % self.data_size:
            raise ValueError(f"batch size {batch_size} does not divide over "
                             f"{self.data_size} data ranks")
        per = batch_size // self.data_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


def _build(grid: np.ndarray, names: Tuple[str, ...]) -> Mesh:
    """The mesh with its groups; a joined process group of one rank gets
    groups of one too, so that its step runs the distributed path (DDP,
    the global denominators) with every reduction an identity."""
    rank = distributed.rank()
    mesh = Mesh(names, grid, rank)
    if not dist.is_initialized():
        return mesh
    model = grid.shape[-1]
    # Model groups: adjacent ranks; data groups: one model column each.
    mesh.model_group = _new_groups(grid.reshape(-1, model), rank)
    mesh.data_group = _new_groups(grid.reshape(-1, model).T, rank)
    return mesh


def create_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the process group (one rank
    without one)."""
    grid = mesh_grid(distributed.world_size(), data, model)
    return _build(grid, (DATA_AXIS, MODEL_AXIS))


def create_hybrid_mesh(dcn: int, data: Optional[int] = None,
                       model: int = 1) -> Mesh:
    """A (dcn, data, model) mesh: ``dcn`` slices of data x model ranks,
    laid over the flat rank list (the port sees no slice topology)."""
    grid = mesh_grid(distributed.world_size(), data, model, dcn)
    return _build(grid, (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def shard_batch(mesh: Optional[Mesh], batch: Dict) -> Dict:
    """This rank's rows of a global host batch (arrays, tensors and the
    ``ids`` list alike), for callers that hold the whole batch; the
    pipelines assemble only their rows (``data/pipeline.py``)."""
    if mesh is None or mesh.data_size == 1:
        return batch
    rows = mesh.rows(len(batch["actions"]))
    return {k: v[rows] for k, v in batch.items()}
