"""Execution of the port's forward chain (see parallel/fused.py)."""
