"""Device idle time under the train step's optimizer, in ms a step: the
traced span's idle seconds that lie under a ``step.optimizer`` span of the
main thread, the innermost span open there (``benchmark/spans.py:
idle_by_span``), over the steps those spans cover."""


def read(data):
    trace = data.get("trace")
    if not trace or not trace["idle_by_span"] \
            or not trace["span_units"].get("step.optimizer"):
        return None
    return (1e3 * trace["idle_by_span"].get("step.optimizer", 0.0)
            / trace["span_units"]["step.optimizer"])
