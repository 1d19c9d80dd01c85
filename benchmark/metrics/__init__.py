"""One reader a metric, named as the metric: ``read(rec)`` takes the run's
``harness.Record`` and returns the value, or None when the run has nothing
to read for it (the harness then leaves the metric out)."""
