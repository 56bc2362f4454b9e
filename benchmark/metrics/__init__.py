"""One reader per per-layer metric: ``read(ctx) -> float | None``. A reader
that finds nothing to read in a run returns None, and the metric is left out
of the result line. Module names are the metric names with ``.`` as ``_``."""
