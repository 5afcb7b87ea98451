"""Faults planted under the timed path, to show that the checks catch
them: ``benchmark/control.py`` reads them on the card at a cell's size,
``benchmark/tests/test_bench_faults.py`` at a size the CPU holds. A run
of ``benchmark/run.py`` never plants one.

  stale_state     the train step returns its state unchanged (no update)
  half_batch      the train step sees the first half of each batch's rows,
                  its mean taken over those alone
  altered_token   the rollout's command logits of row 0 at step 5 are
                  rolled by one, so its decode serves another command
  corrupt_batch   the data layer's reader returns each sequence with its
                  first frame's first pixel changed
"""

from __future__ import annotations

import contextlib

FAULTS = ("stale_state", "half_batch", "altered_token", "corrupt_batch")


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: none) for the duration."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    import videocad_tpu_torch.data.dataset as dataset
    import videocad_tpu_torch.infer.rollout as rollout
    import videocad_tpu_torch.train as train
    from videocad_tpu_torch.train.state import TrainState

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "stale_state":
        patch(TrainState, "apply_gradients", lambda self: self)
    elif name == "half_batch":
        make = train.make_train_step

        def make_half(*args, **kwargs):
            inner = make(*args, **kwargs)

            def step(state, batch, seed):
                rows = batch["actions"].shape[0] // 2
                return inner(state, {k: v[:rows] if hasattr(v, "shape")
                                     else v for k, v in batch.items()}, seed)
            return step
        patch(train, "make_train_step", make_half)
    elif name == "corrupt_batch":
        read = dataset.VideoCADDataset.__getitem__

        def corrupt(self, idx):
            item = read(self, idx)
            item["frames"][0, 0, 0, 0] ^= 0x55
            return item
        patch(dataset.VideoCADDataset, "__getitem__", corrupt)
    else:
        infer = rollout.sequential_inference

        def altered_rollout(*args, **kwargs):
            cmd, par = infer(*args, **kwargs)
            cmd = cmd.clone()
            cmd[0, 5] = cmd[0, 5].roll(1, dims=-1)
            return cmd, par
        patch(rollout, "sequential_inference", altered_rollout)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
