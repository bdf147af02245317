"""Plain PyTorch references: no kernel, no code of the port."""
