"""The held experts' grouped products' share of their roofline: the least
time of each `dispatch/expert_product` span's three products at the
published peaks (`costs_lm.expert_product` of its rows a held expert, D
and F) over the span's `device_ms` (CUDA events around the three
products), summed over the window's spans, in percent."""
import costs_lm


def read(facts: dict):
    need = spent = 0.0
    for ev in facts.get("events", ()):
        args = ev["args"]
        if ev["ph"] != "X" or ev["name"] != "dispatch/expert_product" \
                or "device_ms" not in args:
            continue
        need += costs_lm.bound_s(*costs_lm.expert_product(
            args["rows"], args["D"], args["F"]))
        spent += args["device_ms"] / 1e3
    return 100.0 * need / spent if spent else None
