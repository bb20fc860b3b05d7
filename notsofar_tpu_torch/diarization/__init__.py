"""Word-based diarization (TitaNet embeddings + NMESC clustering)."""
