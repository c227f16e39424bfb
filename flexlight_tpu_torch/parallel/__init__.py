from .halo import exchange_halo, with_halo
from .tile_sharding import (frame_pipeline_sharded, frame_pipeline_sharded_halo, make_mesh,
                            render_mrt_sharded)

__all__ = ["exchange_halo", "frame_pipeline_sharded", "frame_pipeline_sharded_halo",
           "make_mesh", "render_mrt_sharded", "with_halo"]
