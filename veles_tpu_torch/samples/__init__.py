"""Sample workflows of the port."""
