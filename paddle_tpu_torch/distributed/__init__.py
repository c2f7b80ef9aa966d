"""Distributed runtime pieces of the port (slice D brings the rest)."""
