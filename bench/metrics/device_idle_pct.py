"""Share of the traced window in which no operation ran on the card (the
mean over the cards of the run), from `torch.profiler`, in percent.  The
traced window is the whole of the driver's window, a serve window's drain
of its last requests included."""


def read(facts: dict):
    prof = facts.get("profile")
    if not prof or not prof["device_events"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / facts["traced_s"])
