"""Fixed-capacity host map (numpy) and its checkpoint."""
from .map import MapConfig, MapStore  # noqa: F401
