"""Seconds to build the scene (``scene.build_scene``: units, field, the IC
on its generator, the orbit placement, the force model), on the host clock
with the device fenced on both sides."""
LAYER = "scene"
MOVES = "setup_s"
UNIT = "s"


def read(run):
    return run.scene_build_s
