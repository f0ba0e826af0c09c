"""The port's thumbnail cache (``ingest/thumbcache.py``), its use by the
decode pool and by ``scan_directory(thumb_cache=)``, against the JAX
package's: they mirror tests/test_ingest.py's thumbnail-cache tests.

Both caches use PIL, so a tile is byte-equal to the reference's for the same
decoded pixels and either package reads the other's tiles. A photo's
embedding on a cache hit is bitwise its embedding on the first, cache-miss
scan.
"""

import glob
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from image_search_tpu.ingest.thumbcache import ThumbCache as RefThumbCache
from image_search_tpu_torch.config import get_config
from image_search_tpu_torch.index.index import VectorIndex
from image_search_tpu_torch.ingest import decode as decode_mod
from image_search_tpu_torch.ingest.decode import DecodePool
from image_search_tpu_torch.ingest.pipeline import scan_directory
from image_search_tpu_torch.ingest.thumbcache import QUALITY, ThumbCache
from image_search_tpu_torch.models.convert import build_model, init_params
from image_search_tpu_torch.models.embedder import ClipEmbedder


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch and BLAS calls: threads oversubscribe the test workers."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _corpus(root, n=3, size=(900, 1200)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(9)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"big_{i}.jpg")
        Image.fromarray(rng.integers(0, 256, size=size + (3,), dtype=np.uint8)).save(p, quality=95)
        paths.append(p)
    return paths


def _full_size(path):
    """A photo decoded at full size (the pool's decode is drafted)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _entries(d):
    return sorted(glob.glob(os.path.join(d, "*", "*.jpg")))


def test_tiles_are_byte_equal_and_read_by_either_package(tmp_path):
    """The same decoded pixels make the same tile file under the same key,
    ``put`` returns the re-decoded tile, and each package's ``get`` reads
    the other's tile."""
    (p,) = _corpus(str(tmp_path / "pics"), n=1)
    full = _full_size(p)
    port, ref = ThumbCache(str(tmp_path / "port")), RefThumbCache(str(tmp_path / "ref"))
    assert QUALITY == 92 and port.max_edge == ref.max_edge == 448
    assert port.get(p) is None and ref.get(p) is None
    tile, want = port.put(p, full), ref.put(p, full)
    np.testing.assert_array_equal(tile, want)
    assert min(tile.shape[:2]) == 448 and abs(tile.shape[1] / tile.shape[0] - full.shape[1] / full.shape[0]) < 0.01
    (a,), (b,) = _entries(str(tmp_path / "port")), _entries(str(tmp_path / "ref"))
    assert os.path.relpath(a, str(tmp_path / "port")) == os.path.relpath(b, str(tmp_path / "ref"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(ThumbCache(str(tmp_path / "ref")).get(p), tile)
    np.testing.assert_array_equal(RefThumbCache(str(tmp_path / "port")).get(p), tile)
    # a small photo is stored at its own size
    small = full[:300, :400]
    np.testing.assert_array_equal(port.put(p + ".small", small), ref.put(p + ".small", small))
    assert (port.hits, port.misses) == (ref.hits, ref.misses) == (0, 1)


def test_roundtrip_invalidation_and_sweep(tmp_path):
    """A hit returns the pixels ``put`` returned; touching the original
    misses (the key holds mtime and size); a new put sweeps the stale tile."""
    (p,) = _corpus(str(tmp_path / "pics"), n=1)
    full = _full_size(p)
    for cls, d in ((ThumbCache, "port"), (RefThumbCache, "ref")):
        cache = cls(str(tmp_path / d))
        tile = cache.put(p, full)
        np.testing.assert_array_equal(cache.get(p), tile)
        time.sleep(0.01)
        os.utime(p)
        assert cache.get(p) is None
        cache.put(p, full)
        assert cache.get(p) is not None
        assert len(_entries(str(tmp_path / d))) == 1
        assert (cache.hits, cache.misses) == (2, 1)


def test_decode_pool_uses_the_thumb_cache(tmp_path, monkeypatch):
    """The second decode_batch reads tiles only: no original is decoded."""
    paths = _corpus(str(tmp_path / "pics"))
    cache = ThumbCache(str(tmp_path / "thumbs"))
    calls = []
    real = decode_mod.decode_image
    monkeypatch.setattr(decode_mod, "decode_image", lambda p: calls.append(p) or real(p))
    pool = DecodePool(workers=2, thumb_cache=cache)
    try:
        kept1, imgs1 = pool.decode_batch(paths + [str(tmp_path / "missing.jpg")])
        assert kept1 == paths and len(calls) == 4
        kept2, imgs2 = pool.decode_batch(paths)
        assert kept2 == kept1 and len(calls) == 4  # no full decode on the warm pass
        for a, b in zip(imgs1, imgs2):
            np.testing.assert_array_equal(a, b)
    finally:
        pool.close()
    assert (cache.hits, cache.misses) == (3, 4)
    # the reference's cache reads the same tiles
    ref = RefThumbCache(str(tmp_path / "thumbs"))
    for p, img in zip(paths, imgs1):
        np.testing.assert_array_equal(ref.get(p), img)


def test_scan_with_thumb_cache_embeddings_stable(tmp_path):
    """A rescan from tiles indexes bitwise the vectors the cold scan did
    (the model-upgrade path: a fresh index over the same cache), whose tiles
    the reference's cache reads as the port's does."""
    _corpus(str(tmp_path / "pics"), size=(300, 380))
    cfg = get_config("clip-tiny-test")
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), cpu, torch.float32)
    embedder = ClipEmbedder(build_model(cfg, params, cpu, torch.float32))
    cache = ThumbCache(str(tmp_path / "thumbs"))
    idx1 = VectorIndex(cfg.projection_dim, device="cpu")
    scan_directory(embedder, idx1, str(tmp_path / "pics"), thumb_cache=cache)
    assert (cache.hits, cache.misses) == (0, 3) and len(idx1) == 3
    idx2 = VectorIndex(cfg.projection_dim, device="cpu")
    scan_directory(embedder, idx2, str(tmp_path / "pics"), thumb_cache=cache)
    assert (cache.hits, cache.misses) == (3, 3) and len(idx2) == 3
    paths = idx1.live_paths()
    np.testing.assert_array_equal(idx1.get_raw_embeddings(paths), idx2.get_raw_embeddings(paths))
    ref_cache = RefThumbCache(str(tmp_path / "thumbs"))
    for p in paths:
        np.testing.assert_array_equal(ref_cache.get(p), cache.get(p))
    assert ref_cache.hits == 3
