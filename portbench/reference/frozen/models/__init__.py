"""Renderers of the port beside the path tracer's frame path: the rasterizer."""
