"""Optimizers and the trainer of the port."""
