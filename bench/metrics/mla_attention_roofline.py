"""The fused MLA attention's share of its roofline: the least time of each
`dispatch/mla_attention` span's causal forward at the published peaks
(`costs_lm.mla_attention` of its q and v shapes) over the span's
`device_ms` (CUDA events around the call), summed over the window's spans
(the recomputed forwards of remat among them), in percent."""
import ast

import costs_lm


def read(facts: dict):
    need = spent = 0.0
    for ev in facts.get("events", ()):
        args = ev["args"]
        if ev["ph"] != "X" or ev["name"] != "dispatch/mla_attention" \
                or "device_ms" not in args:
            continue
        (b, s, h, d_qk), _, (_, _, _, d_v) = ast.literal_eval(
            args["shapes"])
        need += costs_lm.bound_s(*costs_lm.mla_attention(b, s, h, d_qk,
                                                         d_v))
        spent += args["device_ms"] / 1e3
    return 100.0 * need / spent if spent else None
