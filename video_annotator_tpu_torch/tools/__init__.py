"""Measurement scripts of the port; none is imported by the render paths."""
