"""The parallel layer: data, model and slice axes over
``torch.distributed``, one process a rank.

Port of ``videocad_tpu/parallel``: ``distributed.py`` (joining the process
group), ``mesh.py`` (the rank grid and its groups), ``sharding.py`` (the
tensor-parallel layout), plus ``collectives.py`` (the collectives that
GSPMD inserted under JAX) and ``dryrun.py`` (a multi-rank run of the train,
eval, rollout and checkpoint paths). The modules are imported by name:
``sharding.py`` reads the model's layers, which use ``collectives.py``.
"""
