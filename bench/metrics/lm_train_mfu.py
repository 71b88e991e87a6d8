"""One LM training step's model operations (`costs_lm.train_step`, the
held experts counted by the window's mean routed rows a step, recompute
not counted) over the window's measured time a step, as a share of the
card's dense bfloat16 peak, in percent.  On the card only."""
import costs_lm


def read(facts: dict):
    if not facts.get("on_card") or not facts.get("lm") \
            or not facts.get("steps"):
        return None
    held = facts["held_selections"]
    ops = costs_lm.train_step(facts["lm"], sum(held) / len(held))
    return 100.0 * ops / costs_lm.BF16_FLOPS / facts["step_s"]
