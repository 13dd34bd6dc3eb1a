"""BSDF sampling and evaluation for the wavefront tracer."""
