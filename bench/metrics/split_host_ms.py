"""The host's time issuing the split search, a tree: the summed host
`dur_us` of the window's `trainer/split` spans (one a level) over the
number of distinct iterations among them, in ms.  Counting the trees the
spans name, not the window's steps, keeps it right where the tracer's
ring dropped the first trees.  A program that records no such span reads
none."""


def read(facts: dict):
    spent = 0.0
    trees = set()
    for ev in facts.get("events", ()):
        if ev["ph"] == "X" and ev["name"] == "trainer/split":
            spent += ev["dur_us"]
            trees.add(ev["args"]["iteration"])
    return spent / 1e3 / len(trees) if trees else None
