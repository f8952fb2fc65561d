"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``: ``read(run) -> float | None`` over the traced run's record
(``run.py``'s ``traced_record``). A reader that finds nothing to read
returns None, and the metric is left out of the result line."""
