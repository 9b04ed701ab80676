"""Geometry and association ops of the port."""
