"""Znicz units of the port (forward layers of the serving slice)."""
