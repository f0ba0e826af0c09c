"""Persistent thumbnail cache: decode each original once.

A copy of ``image_search_tpu/ingest/thumbcache.py`` (PIL only, no JAX).
Decoding on the host is the slow stage of a scan: a 12 MP JPEG takes far
longer to decode than its tile takes to embed on the card. The first scan
stores a shortest-edge-``max_edge`` JPEG tile per photo, keyed by (path,
mtime, size); every later decode of that photo -- a rescan after a removal
and restore, a re-embedding for a new model, a fine-tune epoch -- reads the
small tile instead of the original.

Numerics: ``max_edge`` defaults to 448, twice the 224 px model input, the
same margin the JPEG draft decode keeps (ingest/decode.py). Tiles are stored
re-encoded (quality ``QUALITY``) and ``put`` returns the re-decoded pixels,
so the embedding a photo gets on its first (cache-miss) scan is bit-identical
to every later (cache-hit) scan.

Layout: ``<dir>/ab/<sha1(path)>-<mtime_ns>-<size>.jpg`` -- two-level fanout,
self-invalidating keys (a touched original simply misses; stale tiles are
swept on put). Either package reads the tiles the other wrote.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

QUALITY = 92


class ThumbCache:
    def __init__(self, directory: str, max_edge: int = 448):
        self.directory = directory
        self.max_edge = max_edge
        os.makedirs(directory, exist_ok=True)
        self.hits = 0
        self.misses = 0

    # -- keys -----------------------------------------------------------------

    def _entry(self, path: str) -> Optional[str]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        h = hashlib.sha1(path.encode("utf-8", "surrogateescape")).hexdigest()
        return os.path.join(
            self.directory, h[:2], f"{h}-{st.st_mtime_ns}-{st.st_size}.jpg"
        )

    # -- API ------------------------------------------------------------------

    def get(self, path: str) -> Optional[np.ndarray]:
        """Cached tile for ``path``, or None (miss / stale / unreadable)."""
        entry = self._entry(path)
        if entry is None or not os.path.exists(entry):
            self.misses += 1
            return None
        try:
            from PIL import Image

            with Image.open(entry) as im:
                arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
            self.hits += 1
            return arr
        except Exception as err:
            log.warning("thumb cache entry %s unreadable (%s)", entry, err)
            self.misses += 1
            return None

    def put(self, path: str, image: np.ndarray) -> np.ndarray:
        """Store ``image`` (uint8 HWC RGB) for ``path``; returns the pixels a
        later ``get`` will yield (the re-decoded tile), so first-scan and
        rescan embeddings agree bit-for-bit. On any failure the original
        array is returned and ingest continues uncached."""
        entry = self._entry(path)
        if entry is None:
            return image
        try:
            from PIL import Image

            im = Image.fromarray(image)
            h, w = image.shape[:2]
            short = min(h, w)
            if short > self.max_edge:
                scale = self.max_edge / short
                im = im.resize(
                    (max(1, round(w * scale)), max(1, round(h * scale))),
                    Image.BICUBIC,
                )
            buf = io.BytesIO()
            im.convert("RGB").save(buf, "JPEG", quality=QUALITY)
            data = buf.getvalue()
            os.makedirs(os.path.dirname(entry), exist_ok=True)
            # unique tmp name: concurrent puts of the SAME image (live /scan
            # plus an offline scan_dir/finetune sharing one cache dir) must
            # not interleave writes into one tmp file and publish a torn
            # tile; each writer renames its own whole file
            import tempfile

            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(entry),
                prefix=os.path.basename(entry) + ".",
                suffix=".tmp",
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, entry)  # atomic: readers never see a torn tile
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._sweep_stale(path, entry)
            with Image.open(io.BytesIO(data)) as im2:
                return np.asarray(im2.convert("RGB"), dtype=np.uint8)
        except Exception as err:
            log.warning("thumb cache put failed for %s (%s)", path, err)
            return image

    def _sweep_stale(self, path: str, current_entry: str) -> None:
        """Drop superseded tiles of the same original (old mtime/size)."""
        h = hashlib.sha1(path.encode("utf-8", "surrogateescape")).hexdigest()
        d = os.path.dirname(current_entry)
        keep = os.path.basename(current_entry)
        try:
            for fname in os.listdir(d):
                if fname.startswith(h + "-") and fname != keep:
                    os.remove(os.path.join(d, fname))
        except OSError:
            pass
