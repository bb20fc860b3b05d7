"""Logging, wav I/O, stage timing and device selection."""
