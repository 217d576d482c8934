"""ATE/RPE evaluation and trajectory IO."""
from .ate import align_umeyama, ate_rmse, rpe  # noqa: F401
