"""Inverse rendering: parameter access, the Adam loop, checkpoints."""
