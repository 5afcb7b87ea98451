"""Time the train loop waits for its next batch, in ms a step: the
benchmark's own host-clock timer around each ``next()`` of the
device-prefetch iterator over the untraced part of the window, averaged
over its steps."""


def read(data):
    waits = data.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
