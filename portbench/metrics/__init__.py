"""Metric readers, one file a metric, named as in BENCHMARK.json:
``read(run)`` takes the run (portbench/run.Run: the set-up seconds, the
window's seconds, the cell's configuration and mix, each step's record
with the step's shapes and times, the trace's summary when traced) and
returns the value, or None where it finds nothing to read. A reader
counts the operations and bytes it needs from the records' shapes with
portbench/flops.py; a reader of device time names the kernels it times
in ``KERNELS`` (patterns searched in the trace's activity names)."""
