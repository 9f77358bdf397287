"""Data sources, collation and data modules of the port."""
