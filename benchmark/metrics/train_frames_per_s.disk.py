"""Frames trained on a second when the train step is fed from disk: the
real frames of the batches the window's untraced part took, over its wall
clock (host clock; in a traced run, the part after the tracer has
stopped). The same quantity as ``train_frames_per_s``, read per layer in
the disk cell, whose host-bound pace spreads too widely between runs for
any end-to-end bound."""


def read(data):
    frames, wall = data.get("rate_frames"), data.get("rate_window_s")
    if not frames or not wall:
        return None
    return frames / wall
