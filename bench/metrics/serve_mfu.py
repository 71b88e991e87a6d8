"""The served batches' least time at the published peaks (each a `proba`
call over its padded bucket of rows, `costs.apply_call`) over the time of
their `serve/batch` spans (host clock, from the batch's dispatch to its
probabilities on the host), in percent.  On the card only.

Staged: no cell of `BENCHMARK.json` reads this yet (the serve cell is
staged).
"""
import costs


def read(facts: dict):
    if not facts.get("on_card"):
        return None
    m = facts["model"]
    need = spent = 0.0
    for ev in facts.get("events", ()):
        if ev["ph"] == "X" and ev["name"] == "serve/batch":
            need += costs.bound_s(*costs.apply_call(
                ev["args"]["rows"], m["features"], m["borders"], m["trees"],
                m["depth"], m["outputs"]))
            spent += ev["dur_us"] / 1e6
    return 100.0 * need / spent if spent else None
