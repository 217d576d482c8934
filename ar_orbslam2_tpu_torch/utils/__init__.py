from .config import Settings, load_settings  # noqa: F401
