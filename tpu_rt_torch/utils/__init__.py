"""Utilities: profiling and tracing (``profiling.py``), values kept for an
object while it lives (``memo.py``)."""
