"""Session sharding across torch.distributed processes."""
