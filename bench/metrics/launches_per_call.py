"""Kernel launches of the window (`ops.launch_counts()`) over its calls.
The plain versions launch nothing, so a run without kernels reads none."""


def read(facts: dict):
    if not facts.get("launches") or not facts.get("calls"):
        return None
    return facts["launches"] / facts["calls"]
