"""One boosting iteration's least time at the published peaks
(`costs.train_iteration`, `costs.bound_s`) over the window's measured time a
step, in percent.  On the card only."""
import costs


def read(facts: dict):
    if not facts.get("on_card") or not facts.get("steps"):
        return None
    t = facts["train"]
    need = costs.bound_s(*costs.train_iteration(
        t["rows"], t["features"], t["bins"], t["depth"], t["outputs"]))
    return 100.0 * need / facts["step_s"]
