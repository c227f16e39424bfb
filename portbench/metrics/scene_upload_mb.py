"""The MB (10^6 bytes) a frame that the program's scene updates copy to
the device: the attribute `bytes` of the span fl.scene.update
(models/base.py update_scene: the size of the tensors the rebuild made),
summed over the traced stretch and divided by its complete frames. None
where the program keeps no such span or the span has no `bytes`."""

from portbench.metrics.scene_update_ms import per_frame


def read(run):
    try:
        return per_frame(lambda s: s.attrs["bytes"] / 1e6)
    except KeyError:
        return None
