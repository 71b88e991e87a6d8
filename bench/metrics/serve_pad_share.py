"""Share of the scored rows that were padding up to a bucket
(`ServerMetrics.pad_overhead`), in percent.

Staged: no cell of `BENCHMARK.json` reads this yet (the serve cell is
staged).
"""


def read(facts: dict):
    if not facts.get("batches"):
        return None
    return 100.0 * facts["pad_overhead"]
