"""Annotated<T>: the SSE-style streaming envelope used on every response plane.

The port's own copy of dynamo_tpu/pipeline/annotated.py (the port imports nothing of the JAX
package).

Role-equivalent of the reference's lib/runtime/src/protocols/annotated.rs —
each stream element may carry data, a named event (e.g. error or an
annotation like "formatted_prompt"/"llm_metrics"), comments, or a chunk id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")


@dataclass
class Annotated(Generic[T]):
    data: Optional[T] = None
    event: Optional[str] = None
    comment: Optional[list[str]] = None
    id: Optional[str] = None

    ERROR_EVENT = "error"

    @classmethod
    def from_data(cls, data: T) -> "Annotated[T]":
        return cls(data=data)

    @classmethod
    def from_error(cls, message: str) -> "Annotated[T]":
        return cls(event=cls.ERROR_EVENT, comment=[message])

    @classmethod
    def from_annotation(cls, name: str, value: Any) -> "Annotated[T]":
        """A named out-of-band annotation whose value rides in `comment[0]`
        as JSON (matches the reference's annotation convention)."""
        import json

        return cls(event=name, comment=[json.dumps(value)])

    def is_error(self) -> bool:
        return self.event == self.ERROR_EVENT

    def error_message(self) -> Optional[str]:
        if not self.is_error():
            return None
        return self.comment[0] if self.comment else "unknown error"

    def annotation_value(self) -> Any:
        import json

        if self.event is None or not self.comment:
            return None
        try:
            return json.loads(self.comment[0])
        except Exception:
            return self.comment[0]

    def to_wire(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.data is not None:
            out["data"] = self.data
        if self.event is not None:
            out["event"] = self.event
        if self.comment is not None:
            out["comment"] = self.comment
        if self.id is not None:
            out["id"] = self.id
        return out

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "Annotated[Any]":
        return cls(
            data=d.get("data"),
            event=d.get("event"),
            comment=d.get("comment"),
            id=d.get("id"),
        )
