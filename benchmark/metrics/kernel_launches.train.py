"""Device kernels a train step launches: the kernels in the trace (copies
and annotation ranges left out) over the steps traced."""


def read(data):
    trace = data.get("trace")
    if not trace or not trace["units"] or not trace["kernels"]:
        return None
    return trace["kernels"] / trace["units"]
