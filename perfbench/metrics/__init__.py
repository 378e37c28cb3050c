"""Per-layer metrics: one reader module each, ``metrics/<base>.py``, where
``<base>`` is the metric's name up to its first dot. Its layer, unit and
the end-to-end metric it moves are the metric's entry in BENCHMARK.json.
``read(trace)`` returns the number from a profiling.Trace, or None where
the run has nothing to read.

A quantity whose cells report different end-to-end metrics is split by a
suffix: ``kernels_per_step`` moves ``step_ms``; ``kernels_per_step.block``
would move ``step_ms.block`` and read through the same module."""
