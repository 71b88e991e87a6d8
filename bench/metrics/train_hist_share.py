"""Share of the window's iteration time spent in the level histograms:
`TrainingMetrics` hist seconds (CUDA events around the histogram launches)
over its iteration seconds (host clock), in percent.  On the card only."""


def read(facts: dict):
    training = facts.get("training")
    if not facts.get("on_card") or not training or not training["iterations"]:
        return None
    return 100.0 * training["hist_frac"]
