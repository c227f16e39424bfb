"""The host's ms a frame inside the program's spans fl.raster.shade
(models/rasterizer.py raster_frame, around each layer's _shade: the eager
Cook-Torrance glue of every light and its shadow cast), over the complete
frames the program kept in the traced stretch. None where the program
keeps no such span."""

from portbench.metrics.raster_host_ms import raster_ms


def read(run):
    return raster_ms("fl.raster.shade")
