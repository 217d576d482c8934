"""Native (C++) host map-graph bookkeeping, loaded via ctypes."""
from . import mapgraph  # noqa: F401
