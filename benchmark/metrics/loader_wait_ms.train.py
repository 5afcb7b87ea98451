"""Time the train loop waits for its next batch, in ms a step: the
benchmark's span around each ``next()`` of the device-prefetch iterator
over the window, averaged over the window's steps."""


def read(data):
    waits = data.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
