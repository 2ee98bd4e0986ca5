"""Audio path: Whisper transcription, tagging, alignment."""
