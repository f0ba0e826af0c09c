"""Host-side image decoding pool.

The contract of ``image_search_tpu/ingest/decode.py``: a thread pool turns
paths into uint8 RGB HWC arrays, and an image that fails to decode is logged
and skipped; :func:`decode_image_bytes` decodes an uploaded query image,
refusing one that declares more than ``MAX_QUERY_PIXELS``. Decoding uses PIL when it is importable (with the same JPEG
draft downscale as the reference). Uncompressed 24-bit BMP -- a format the
scanner accepts -- also has a small numpy reader, so a machine without PIL
can still scan such a corpus; :func:`write_bmp24` writes one. With a
``ThumbCache`` (``ingest/thumbcache.py``) the pool reads each photo's cached
tile and fully decodes only the misses.
"""

from __future__ import annotations

import io
import logging
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DRAFT_TARGET = 512  # keep >= 2x the 224px model input for exact-enough bicubic

_BMP_HEADER = struct.Struct("<2sIHHIIiiHHIIiiII")  # file header + BITMAPINFOHEADER


def read_bmp24(data: bytes) -> np.ndarray:
    """Uncompressed 24-bit BMP bytes -> uint8 RGB HWC; ValueError otherwise."""
    if len(data) < _BMP_HEADER.size:
        raise ValueError("truncated BMP header")
    (magic, _, _, _, offset, hdr_size, w, h, planes, bpp, compression,
     *_rest) = _BMP_HEADER.unpack_from(data)
    if magic != b"BM" or hdr_size < 40 or planes != 1 or bpp != 24 or compression != 0:
        raise ValueError("not an uncompressed 24-bit BMP")
    if w <= 0 or h == 0:
        raise ValueError(f"bad BMP size {w}x{h}")
    rows = abs(h)
    stride = (3 * w + 3) // 4 * 4
    if offset + stride * rows > len(data):
        raise ValueError("truncated BMP pixel data")
    px = np.frombuffer(data, np.uint8, count=stride * rows, offset=offset)
    px = px.reshape(rows, stride)[:, : 3 * w].reshape(rows, w, 3)
    if h > 0:  # bottom-up rows
        px = px[::-1]
    return np.ascontiguousarray(px[:, :, ::-1])  # BGR -> RGB


def write_bmp24(path: str, rgb: np.ndarray) -> None:
    """Write uint8 RGB HWC as an uncompressed bottom-up 24-bit BMP."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) // 4 * 4
    body = np.zeros((h, stride), np.uint8)
    body[:, : 3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    header = _BMP_HEADER.pack(
        b"BM", _BMP_HEADER.size + body.size, 0, 0, _BMP_HEADER.size,
        40, w, h, 1, 24, 0, body.size, 2835, 2835, 0, 0,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(body.tobytes())


def decode_image(path: str) -> Optional[np.ndarray]:
    """Decode one image to uint8 RGB HWC; None on failure (log-and-skip)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    try:
        if Image is None:
            with open(path, "rb") as f:
                return read_bmp24(f.read())
        with Image.open(path) as im:
            if im.format == "JPEG":
                im.draft("RGB", (_DRAFT_TARGET, _DRAFT_TARGET))
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception as err:  # decoder errors are data-dependent; never fatal
        log.error("Failed to open image %s: %s", path, err)
        return None


# decoded-pixel cap for UNTRUSTED uploaded bytes: a small crafted file can
# declare enormous dimensions (a 20k x 20k PNG fits in the 16 MB request cap
# and decodes to 1.2 GB); 64M pixels is far above any real photo
MAX_QUERY_PIXELS = 64_000_000


def decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode in-memory image bytes (an uploaded query image) to uint8 RGB
    HWC; None on failure or when the declared size exceeds
    ``MAX_QUERY_PIXELS``, checked from the header before any pixel is
    decoded. The reference's copy, without its native decoder."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    try:
        if Image is None:
            arr = read_bmp24(data)  # reads within ``data``: no decode bomb
            if arr.shape[0] * arr.shape[1] > MAX_QUERY_PIXELS:
                log.warning("rejecting %dx%d query image (> %d pixels)", arr.shape[1], arr.shape[0], MAX_QUERY_PIXELS)
                return None
            return arr
        with Image.open(io.BytesIO(data)) as im:
            w, h = im.size
            if w * h > MAX_QUERY_PIXELS:
                log.warning("rejecting %dx%d query image (> %d pixels)", w, h, MAX_QUERY_PIXELS)
                return None
            if im.format == "JPEG":
                im.draft("RGB", (_DRAFT_TARGET, _DRAFT_TARGET))
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception as err:  # decoder errors are data-dependent; never fatal
        log.error("Failed to decode %d uploaded bytes: %s", len(data), err)
        return None


class DecodePool:
    """Thread-pool batch decoder: paths -> (kept_paths, arrays).

    With a ``thumb_cache`` every path is looked up in the tile cache first;
    only misses pay a full decode, and the decoded tile is stored, so no
    photo is fully decoded twice, across rescans and restarts."""

    def __init__(self, workers: int = 16, thumb_cache=None):
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="decode")
        # batch orchestration runs on its own thread: submitting it to the
        # worker pool would deadlock at workers=1
        self._batcher = ThreadPoolExecutor(max_workers=2, thread_name_prefix="decode-batch")
        self._thumbs = thumb_cache

    def _decode_one(self, path: str) -> Optional[np.ndarray]:
        if self._thumbs is not None:
            tile = self._thumbs.get(path)
            if tile is not None:
                return tile
            arr = decode_image(path)
            if arr is None:
                return None
            return self._thumbs.put(path, arr)
        return decode_image(path)

    def decode_batch(self, paths: Sequence[str]) -> Tuple[List[str], List[np.ndarray]]:
        results = list(self._pool.map(self._decode_one, paths))
        kept_paths, images = [], []
        for path, arr in zip(paths, results):
            if arr is not None:
                kept_paths.append(path)
                images.append(arr)
        return kept_paths, images

    def submit_batch(self, paths: Sequence[str]):
        """Async variant: returns a future of decode_batch (for pipelining)."""
        return self._batcher.submit(self.decode_batch, paths)

    def close(self) -> None:
        self._batcher.shutdown(wait=False, cancel_futures=True)
        self._pool.shutdown(wait=False, cancel_futures=True)
