"""Lie groups, camera model, multi-view geometry, robust weights."""
