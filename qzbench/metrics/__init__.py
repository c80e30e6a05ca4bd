"""One reader a metric: ``metrics/<name up to its first dot>.py``.

A reader has ``read(run)``, which returns the metric's value or None when
the run holds nothing to read, and may have ``WRAPS`` (label -> wrap
points, ``trace.install``), which a traced run installs.
"""
