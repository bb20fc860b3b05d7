"""The session orchestrator: CSS -> ASR -> diarization -> scoring."""
