"""Time ``DataPipeline.epoch`` waits for a batch's assembly to finish, in
ms a batch: the summed seconds of the port's ``data.wait`` spans inside
the traced span over the batches they cover (their distinct keys;
``benchmark/spans.py:mean_ms``). The recorder is on only there."""

from benchmark import spans


def read(data):
    return spans.mean_ms(data.get("trace"), "data.wait")
