"""The whole train step's share of the card's bf16 peak: the model FLOPs
of forward plus backward a step (``benchmark/flops.py``, from the
configuration's shapes, no recompute) times the window's steps, over the
window's wall clock, over 989 TFLOP/s, in percent. In a traced run the
steps and the wall are those after the tracer has stopped."""

from benchmark.flops import H100_BF16_FLOPS


def read(data):
    steps, wall = data.get("rate_steps"), data.get("rate_window_s")
    if not steps or not wall:
        return None
    rate = data["flops_per_step"] * steps / wall
    return 100.0 * rate / H100_BF16_FLOPS
