"""Time an assembly thread of ``DataPipeline`` takes to read and collate a
batch, in ms a batch: the summed seconds of the port's ``data.assemble``
spans inside the traced span over the batches they cover (their distinct
keys; ``benchmark/spans.py:mean_ms``). The recorder is on only there."""

from benchmark import spans


def read(data):
    return spans.mean_ms(data.get("trace"), "data.assemble")
