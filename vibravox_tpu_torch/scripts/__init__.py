"""Command-line scripts of the port."""
