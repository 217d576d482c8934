"""Windowed and brute-force descriptor search."""
