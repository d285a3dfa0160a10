"""Input modes of the port's CLI: http server, interactive text, jsonl batch."""
