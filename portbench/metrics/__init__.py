"""Per-layer metric readers, one module a metric, found by name from
``BENCHMARK.json``; ``_layers`` holds what they share."""
