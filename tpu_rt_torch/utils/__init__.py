"""Utilities: profiling and tracing (``profiling.py``)."""
