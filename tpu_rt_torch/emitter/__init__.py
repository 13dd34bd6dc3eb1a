"""Emitter sampling for next-event estimation, and the miss shader."""
