"""Losses of the port (GAN and reconstruction)."""
