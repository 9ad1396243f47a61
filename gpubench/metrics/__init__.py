"""One reader a metric, named as the metric: ``read(run)`` takes a
:class:`gpubench.harness.Run` and returns the value, or None when the run
has nothing to read."""
