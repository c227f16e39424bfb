"""Device-side ops of the port: buffers, geometry, traversal, shading."""
