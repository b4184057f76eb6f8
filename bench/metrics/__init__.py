"""The per-layer metrics, one reader a module, found by the metric's name
in ``BENCHMARK.json``.  Each module says what it reads, its unit and the
end-to-end metric it should move, and defines ``read(run)``: the value from
a :class:`bench.harness.runner.RunData`, or ``None`` where this run has
nothing to read (the harness then leaves the metric out of the line)."""
