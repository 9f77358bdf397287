"""Models of the port (NCW ``nn.Module``s with the reference's state-dict names)."""
