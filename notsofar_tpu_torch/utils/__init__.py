"""Logging, wav I/O, stage timing, device selection, text normalization
and scoring."""
