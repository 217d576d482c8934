"""AR layer: plane RANSAC, cube anchoring, overlay render, marker pose."""
from .plane import detect_plane, Plane  # noqa: F401
from .viewer import ViewerAR  # noqa: F401
