"""The benchmark's harness: reading `BENCHMARK.json` and a cell's files,
making inputs from the seed, driving the program through a measured
window, reading the trace, and judging the outputs against `reference`.

Nothing here names a cell, a configuration or a per-layer metric: each is
found by the name `BENCHMARK.json` gives it (`spec`)."""
