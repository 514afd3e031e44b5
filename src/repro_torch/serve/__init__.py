"""Serving engine of the port."""
