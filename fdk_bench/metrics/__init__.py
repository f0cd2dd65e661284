"""Metric readers, one file each, named as the metric: ``read(record)``
returns the metric's value from the run's record, or None where the run
recorded nothing it could be read from."""
