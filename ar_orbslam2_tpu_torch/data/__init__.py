from .synthetic import (  # noqa: F401
    SyntheticScene, make_scene, orbit_trajectory, forward_trajectory,
    observe_frame, render_plane_sequence,
)
