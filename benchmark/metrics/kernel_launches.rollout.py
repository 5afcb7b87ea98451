"""Device kernels a rollout's decode step launches: the kernels of the
traced rollouts over their decode steps (the frame and CAD encoders'
kernels included, as a rollout pays them once)."""


def read(data):
    trace = data.get("trace")
    if not trace or not trace["units"] or not trace["kernels"]:
        return None
    return trace["kernels"] / trace["units"]
