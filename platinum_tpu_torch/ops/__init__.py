"""Samplers, LUTs, lookups, shading frames, hit data and ray tracers."""
