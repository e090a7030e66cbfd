"""Static analysis of the port: the shared `Finding` record and the
kernel ledger (analysis/resources.py)."""
