"""Znicz units of the port: forward layers, their gradient twins, the
evaluator and the decision."""
