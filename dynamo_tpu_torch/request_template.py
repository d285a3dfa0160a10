"""Request template: JSON defaults applied to incoming OpenAI requests.

The port's own copy of dynamo_tpu/request_template.py (the port imports nothing of the JAX
package).

Role-equivalent of lib/llm/src/request_template.rs:18-30 — a small JSON
file ({"model": ..., "temperature": ..., "max_completion_tokens": ...})
loaded at frontend start; its values fill fields the client omitted, so a
deployment can pin a default model + sampling without client changes
(launch/dynamo-run flags.rs:162 `--request-template`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass(frozen=True)
class RequestTemplate:
    model: str
    temperature: float
    max_completion_tokens: int

    @classmethod
    def load(cls, path: str) -> "RequestTemplate":
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return cls(
            model=str(d["model"]),
            temperature=float(d["temperature"]),
            max_completion_tokens=int(d["max_completion_tokens"]),
        )

    def apply_chat(self, body: dict) -> dict:
        """Fill omitted/zero fields in a raw chat-completions body (ref
        http/service/openai.rs:302-311: model when empty, temperature when
        0/absent, max_completion_tokens when 0/absent)."""
        if not body.get("model"):
            body["model"] = self.model
        if not body.get("temperature"):
            body["temperature"] = self.temperature
        if not body.get("max_completion_tokens") and not body.get(
            "max_tokens"
        ):
            body["max_completion_tokens"] = self.max_completion_tokens
        return body

    def apply_completion(self, body: dict) -> dict:
        """Defaults for /v1/completions (max_tokens is the completions-API
        spelling)."""
        if not body.get("model"):
            body["model"] = self.model
        if not body.get("temperature"):
            body["temperature"] = self.temperature
        if not body.get("max_tokens"):
            body["max_tokens"] = self.max_completion_tokens
        return body

    def apply_responses(self, body: dict) -> dict:
        """Same defaults for a /v1/responses body (ref openai.rs:465-474:
        max_output_tokens is the responses-API spelling)."""
        if not body.get("model"):
            body["model"] = self.model
        if not body.get("temperature"):
            body["temperature"] = self.temperature
        if not body.get("max_output_tokens"):
            body["max_output_tokens"] = self.max_completion_tokens
        return body
