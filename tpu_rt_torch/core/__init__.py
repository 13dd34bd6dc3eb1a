"""Vector, frame and Fresnel math, and the sample warps."""
