"""The apply call's copy of the caller's rows to the card: the summed
`device_ms` (CUDA events around the copy) of the window's `plan/h2d`
spans over the window's calls, in ms a call.  A program that records no
such span reads none."""


def read(facts: dict):
    spent = sum(ev["args"]["device_ms"] for ev in facts.get("events", ())
                if ev["ph"] == "X" and ev["name"] == "plan/h2d"
                and "device_ms" in ev["args"])
    if not spent or not facts.get("calls"):
        return None
    return spent / facts["calls"]
