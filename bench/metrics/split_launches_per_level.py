"""Kernel launches a level of the trainer's split search: the summed
`launches` of the window's `dispatch/split_level` spans (the kernels the
split kernel's launcher starts on the card a level) over the number of
`trainer/split` spans (one a level).  A program that dispatches no
`split_level` op, whose split search is library ops issued from the
host, records no such span and reads none."""


def read(facts: dict):
    launches = levels = 0
    seen = False
    for ev in facts.get("events", ()):
        if ev["ph"] != "X":
            continue
        if ev["name"] == "dispatch/split_level":
            seen = True
            launches += ev["args"].get("launches", 0)
        elif ev["name"] == "trainer/split":
            levels += 1
    return launches / levels if seen and levels else None
