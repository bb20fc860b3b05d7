"""Whisper ASR: mel frontend, tokenizer, decoding, transcription."""
