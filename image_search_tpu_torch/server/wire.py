"""Wire types — the JSON contract, 1:1 with the reference's ``data`` crate
(the upstream project's ``data/src/lib.rs``).

Kept as plain dataclasses with (de)serialization helpers so the contract is
explicit and testable rather than implied by dict literals. The reference
also defines ``ImageReferenceEmbedding`` and ``ImageReferenceScore``
(lib.rs:27-48) which nothing uses — mirrored here for completeness and
because ``score`` IS surfaced by our server (the reference computes the
similarity and then drops it, main.rs:24-28).
"""

from __future__ import annotations

import dataclasses
import urllib.parse
from typing import Any, Dict, List


@dataclasses.dataclass
class SearchParams:
    """POST /search request body (lib.rs:4-9; referenced_images defaults [])."""

    q: str
    referenced_images: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "SearchParams":
        q = d["q"]
        refs = d.get("referenced_images", []) or []
        if not isinstance(q, str) or not isinstance(refs, list) or not all(
            isinstance(r, str) for r in refs
        ):
            raise ValueError("invalid SearchParams")
        return SearchParams(q=q, referenced_images=refs)


@dataclasses.dataclass
class ImageReference:
    """One result row (lib.rs:15-26): id = url-encoded path."""

    id: str
    image_path: str
    score: float | None = None  # additive field; absent in the reference

    @staticmethod
    def for_path(image_path: str, score: float | None = None) -> "ImageReference":
        return ImageReference(
            id=urllib.parse.quote(image_path, safe=""),
            image_path=image_path,
            score=score,
        )

    def to_json(self) -> Dict[str, Any]:
        d = {"id": self.id, "image_path": self.image_path}
        if self.score is not None:
            d["score"] = self.score
        return d


@dataclasses.dataclass
class SearchResponse:
    """POST /search response body (lib.rs:10-13)."""

    images: List[ImageReference]

    def to_json(self) -> Dict[str, Any]:
        return {"images": [i.to_json() for i in self.images]}


@dataclasses.dataclass
class ImageReferenceEmbedding:
    """lib.rs:27-41 — declared by the reference, unused by its routes."""

    id: str
    image_path: str
    embedding: List[float]


@dataclasses.dataclass
class ImageReferenceScore:
    """lib.rs:43-48 — declared by the reference, unused by its routes."""

    id: str
    image_path: str
    score: float


@dataclasses.dataclass
class ImagePathResult:
    """lib.rs:49-52 — dedup row shape (our store returns plain sets)."""

    image_path: str
