"""Kernel K1's share of its roofline in the train step: the least time its
calls of the traced steps could take (``benchmark/kernels/k1.py``: the
larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s, per call) over
the summed device time of the kernels its source names, in percent."""

from benchmark.kernels import k1


def read(data):
    trace = data.get("trace")
    if not trace or not trace["units"] or "k1_bound_per_step" not in data:
        return None
    spent = k1.device_seconds(trace["device_s_by_name"])
    if spent <= 0:
        return None
    return 100.0 * data["k1_bound_per_step"] * trace["units"] / spent
