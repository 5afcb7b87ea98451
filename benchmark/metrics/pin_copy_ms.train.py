"""Time ``device_prefetch`` takes to pin a batch and enqueue its copy to
the card, in ms a batch: the summed seconds of the port's ``data.copy``
spans inside the traced span over the batches they cover (their distinct
keys; ``benchmark/spans.py:mean_ms``). The recorder is on only there."""

from benchmark import spans


def read(data):
    return spans.mean_ms(data.get("trace"), "data.copy")
