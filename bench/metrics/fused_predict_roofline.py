"""The fused prediction kernel's share of its roofline: the least time of
each `dispatch/fused_predict` span's launch at the published peaks
(`costs.fused_predict` of its operand shapes) over the span's `device_ms`
(CUDA events around the launch), summed over the window's spans, in
percent."""
import ast

import costs


def read(facts: dict):
    need = spent = 0.0
    for ev in facts.get("events", ()):
        args = ev["args"]
        if ev["ph"] != "X" or ev["name"] != "dispatch/fused_predict" \
                or "device_ms" not in args:
            continue
        x, borders, splits, _, leaves = ast.literal_eval(args["shapes"])[:5]
        need += costs.bound_s(*costs.fused_predict(
            x[0], x[1], borders[0], splits[0], splits[1], leaves[2]))
        spent += args["device_ms"] / 1e3
    return 100.0 * need / spent if spent else None
