"""Training tasks of the port."""
