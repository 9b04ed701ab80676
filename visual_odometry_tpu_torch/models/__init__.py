"""Tracking pipeline and landmark map of the port."""
