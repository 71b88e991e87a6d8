"""One apply call's least time on the cards of the run at the published
peaks (`costs.apply_call`, `costs.bound_s`) over the window's measured time
a call, in percent.  On the card only."""
import costs


def read(facts: dict):
    if not facts.get("on_card") or not facts.get("calls"):
        return None
    m = facts["model"]
    need = costs.bound_s(*costs.apply_call(
        facts["rows_per_call"], m["features"], m["borders"], m["trees"],
        m["depth"], m["outputs"]), chips=facts["chips"])
    return 100.0 * need / facts["call_s"]
