"""Model definitions (torch.nn)."""
