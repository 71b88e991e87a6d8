"""Share of the training steps' device time spent in the MoE layers'
forward passes (the first and remat's recomputation): the summed
`device_ms` of the window's `train/moe_layer` spans (routing, the held
experts and the shared expert of one layer) over that of its `train/step`
spans, in percent.  A program that records no such span reads none."""


def read(facts: dict):
    moe = step = 0.0
    for ev in facts.get("events", ()):
        if ev["ph"] != "X" or "device_ms" not in ev["args"]:
            continue
        if ev["name"] == "train/moe_layer":
            moe += ev["args"]["device_ms"]
        elif ev["name"] == "train/step":
            step += ev["args"]["device_ms"]
    return 100.0 * moe / step if moe and step else None
