"""Metrics and spans of the port (copies of what serving uses)."""
