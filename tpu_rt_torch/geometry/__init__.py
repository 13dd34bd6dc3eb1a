"""Geometry on the host: the BVH that the mesh cluster tables are cut from."""
