"""One file a per-layer metric, named as in ``BENCHMARK.json``, each with
``read(run)``: the metric's value, or None where the run has nothing to
read it from (the harness then leaves it out)."""
