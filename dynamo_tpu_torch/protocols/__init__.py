"""Request and response types of the port: token space (common), OpenAI
shapes (openai), the SSE codec and the stream aggregators."""
