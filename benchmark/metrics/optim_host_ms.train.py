"""Host time of the train step's optimizer (``TrainState.apply_gradients``:
the clip and Adam), in ms a step: the summed seconds of the port's
``step.optimizer`` spans inside the traced span over the steps they
cover (their distinct keys; ``benchmark/spans.py:mean_ms``). The
recorder is on only there."""

from benchmark import spans


def read(data):
    return spans.mean_ms(data.get("trace"), "step.optimizer")
