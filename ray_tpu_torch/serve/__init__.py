"""Serving side of the port."""
