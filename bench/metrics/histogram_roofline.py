"""The level histogram kernel's share of its roofline: the least time of
each `dispatch/histogram` span's launch at the published peaks
(`costs.histogram` of its operand shapes and bins) over the span's
`device_ms` (CUDA events around the launch), summed over the window's
spans, in percent."""
import ast

import costs


def read(facts: dict):
    need = spent = 0.0
    for ev in facts.get("events", ()):
        args = ev["args"]
        if ev["ph"] != "X" or ev["name"] != "dispatch/histogram" \
                or "device_ms" not in args:
            continue
        (f, n), _, (_, s) = ast.literal_eval(args["shapes"])[:3]
        need += costs.bound_s(*costs.histogram(
            f, n, args["n_leaves"], args["n_bins"], s,
            bin_bytes=1 if args["dtype"] == "uint8" else 4))
        spent += args["device_ms"] / 1e3
    return 100.0 * need / spent if spent else None
