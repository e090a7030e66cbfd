"""Loaders of the port (see loader/base.py)."""
