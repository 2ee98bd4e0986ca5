"""OpenAI-compatible chat-completions serving (server.py, __main__.py)."""
