"""Per-layer metric readers, one a file, each named as its metric.

``read(run)`` takes the traced run's record (``tasks_ms``, ``queries``,
the program's counter deltas, the bytes each step had to move, and the
reduced ``trace``) and returns the number, or None when there is nothing
to read.  ``RANGES`` names the profiler ranges a reader needs attributed.
"""
