"""The scan pipeline: walk -> dedup -> decode -> embed -> index.

Port of ``image_search_tpu/ingest/pipeline.py::scan_directory`` for one
process: dedup before decode, then decode chunk N+1 on the pool while chunk N
embeds on the device (the embed dispatch returns without waiting), then
append chunk N to the index and its store. With a ``thumb_cache`` the decode
reads cached tiles (``ingest/thumbcache.py``). The multi-host SPMD scan is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Sequence

from image_search_tpu_torch.ingest.decode import DecodePool
from image_search_tpu_torch.ingest.walk import find_images

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ScanStats:
    found: int = 0
    skipped_existing: int = 0
    decode_failures: int = 0
    embedded: int = 0
    seconds: float = 0.0
    pruned: int = 0  # images tombstoned by --prune-on-scan

    @property
    def images_per_sec(self) -> float:
        return self.embedded / self.seconds if self.seconds > 0 else 0.0


def scan_directory(
    embedder,
    index,
    media_dir: str,
    chunk_size: int = 500,
    decode_workers: int = 16,
    skip_paths=None,
    thumb_cache=None,
) -> ScanStats:
    """Embed every new image under ``media_dir`` into ``index``."""
    t0 = time.monotonic()
    stats = ScanStats()
    pool = DecodePool(workers=decode_workers, thumb_cache=thumb_cache)
    try:
        all_paths = find_images(media_dir)
        stats.found = len(all_paths)
        # dedup before decode: only new paths cost anything; skip_paths are
        # explicitly removed images that must not come back on a rescan
        skip = skip_paths or ()
        new_paths = [p for p in all_paths if not index.has_path(p) and p not in skip]
        stats.skipped_existing = stats.found - len(new_paths)
        log.info("Found %d images of which %d are new", stats.found, len(new_paths))

        chunks = [new_paths[i : i + chunk_size] for i in range(0, len(new_paths), chunk_size)]
        if not chunks:
            stats.seconds = time.monotonic() - t0
            return stats

        inflight = pool.submit_batch(chunks[0])
        pending: List = []  # [(paths, device embeddings)]
        for ci in range(len(chunks)):
            kept_paths, images = inflight.result()
            stats.decode_failures += len(chunks[ci]) - len(kept_paths)
            if ci + 1 < len(chunks):
                inflight = pool.submit_batch(chunks[ci + 1])  # overlap decode
            if not kept_paths:
                continue
            pending.append((kept_paths, embedder.embed_images_async(images)))
            # drain the previous chunk (it had a whole decode round to finish)
            # so memory stays bounded at ~2 chunks
            if len(pending) > 1:
                _flush(index, *pending.pop(0), stats)
        for done_paths, done_emb in pending:
            _flush(index, done_paths, done_emb, stats)

        stats.seconds = time.monotonic() - t0
        log.info(
            "Scan complete: %d embedded, %d already present, %d decode failures, %.1fs (%.1f img/s)",
            stats.embedded, stats.skipped_existing, stats.decode_failures,
            stats.seconds, stats.images_per_sec,
        )
        return stats
    finally:
        pool.close()


def _flush(index, paths: Sequence[str], emb_dev, stats: ScanStats) -> None:
    emb = emb_dev[: len(paths)].float().cpu().numpy()  # drop bucket padding
    stats.embedded += index.add(paths, emb)
