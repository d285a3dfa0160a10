"""The port's OpenAI-compatible HTTP frontend."""
