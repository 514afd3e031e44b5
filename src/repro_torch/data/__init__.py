"""Data pipeline of the port."""
