"""Processes, collectives and data parallelism over torch.distributed."""
