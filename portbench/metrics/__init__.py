"""Per-layer metric readers: ``<name>.py`` holds ``read(obs)``, which
returns the metric from the run's observations (counters, harness spans,
the trace's summary) or None where the run has nothing to read."""
