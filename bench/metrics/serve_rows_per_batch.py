"""Rows a scored batch held, over the window: the server's counters
(`ServerMetrics.served_rows` / `batches`).

Staged: no cell of `BENCHMARK.json` reads this yet (the serve cell is
staged).
"""


def read(facts: dict):
    if not facts.get("batches"):
        return None
    return facts["served_rows"] / facts["batches"]
