"""Post-processing of the port: temporal accumulation, denoise, FXAA."""
