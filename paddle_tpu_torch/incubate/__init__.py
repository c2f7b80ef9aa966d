"""Incubating operators (serving-path attention)."""
