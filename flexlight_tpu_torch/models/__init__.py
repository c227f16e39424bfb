"""Renderers of the port."""
