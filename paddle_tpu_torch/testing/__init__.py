"""Test-support modules (fault injection)."""
