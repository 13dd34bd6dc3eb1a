"""Geometry: the host BVH the mesh cluster tables are cut from, the
analytic intersectors and the wavefront tracer's ray queries."""
