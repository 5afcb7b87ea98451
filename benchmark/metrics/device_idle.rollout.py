"""Share of the traced window of the rollout in which no operation ran
on the device: 1 - (union of the device operations' intervals) / (traced
wall), in percent (torch.profiler)."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
