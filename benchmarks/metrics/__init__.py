"""Per-layer metrics: ``<name>.py`` reads the metric ``<name>`` of
``BENCHMARK.json`` from a traced run's context (``read(ctx)``; None when
there is nothing to read)."""
