"""Metrics of the port: speech enhancement, text and speaker verification."""
