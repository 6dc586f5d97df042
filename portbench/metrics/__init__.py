"""One module a metric, found by the metric's name (catalog.metric). Each
gives UNIT, BETTER and SOURCE, a per-layer metric also LAYER, and
``read(run)`` (run.Run) -> the value, or None where the run holds nothing
to read it from (the harness then leaves the metric out)."""
