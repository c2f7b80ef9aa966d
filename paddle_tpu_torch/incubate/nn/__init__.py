"""Incubating layers and functions."""
