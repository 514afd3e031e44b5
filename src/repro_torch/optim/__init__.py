"""Optimizer of the port: AdamW with fp32 master weights."""
