"""Pose optimization, two-view initialization, local bundle adjustment."""
