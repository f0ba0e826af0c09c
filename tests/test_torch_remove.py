"""Removal: the index's tombstones and exclusions, and the engine's
``remove_images`` / ``restore_images`` / ``prune_missing`` and
``--prune-on-scan``, against the JAX package's on the same rows and photos.

The index tests use the exact rows of tests/test_torch_index.py (int8
scores bitwise). The engine tests run one sequence on one pair of engines
that share a photo directory (each its own index directory): remove, rescan,
restart, restore, prune, remove after a prune, an unavailable media tree,
compaction. Every count, flag and exclusion set must be equal; searches
return the same photos in the same order with scores within 1e-5, as in
tests/test_torch_server.py. They mirror the reference's own tests in
tests/test_server.py.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_tpu.config import tiny_test_config
from image_search_tpu.index import EmbeddingStore as JaxStore
from image_search_tpu.index import VectorIndex as JaxIndex
from image_search_tpu.models import init_params as jax_init_params
from image_search_tpu.models.convert import save_checkpoint
from image_search_tpu.server import engine as ref_engine_mod
from image_search_tpu.server.args import ServerArgs as RefArgs
from image_search_tpu.server.engine import SearchEngine as RefEngine
from image_search_tpu.utils.metrics import global_metrics as ref_metrics
from image_search_tpu_torch.index.index import EmbeddingStore, VectorIndex
from image_search_tpu_torch.server.engine import SearchEngine, ServerArgs
from image_search_tpu_torch.utils.metrics import global_metrics
from test_torch_index import DIM, _check, _data, _queries

N_PHOTOS = 6


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


# ---- the index -------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "bfloat16", "int8"])
def test_index_removal_matches_reference(quantize, tmp_path):
    rng = np.random.default_rng(30)
    paths, emb = _data("int8" if quantize == "int8" else None, rng, 120)
    port = VectorIndex(DIM, device="cpu", quantize=quantize, store=EmbeddingStore(str(tmp_path / "p"), DIM))
    ref = JaxIndex(DIM, quantize=quantize, store=JaxStore(str(tmp_path / "r"), DIM))
    port.add(paths, emb)
    ref.add(paths, emb)
    req = [paths[3], paths[3], "/never.jpg", paths[70], paths[119]]
    assert port.remove_paths_report(req, exclude=True) == ref.remove_paths_report(req, exclude=True) == (
        3, [paths[3], paths[70], paths[119]])
    assert port.remove_paths([paths[5]]) == ref.remove_paths([paths[5]]) == 1
    assert port.removed_count == ref.removed_count == 4 and len(port) == len(ref) == 116
    assert port.live_paths() == ref.live_paths()
    for p in (paths[3], paths[5], "/never.jpg", paths[4]):
        assert port.was_removed(p) == ref.was_removed(p)
    q = _queries(quantize, rng, 4)
    got, want = port.search(q, k=30), ref.search(q, k=30)
    if quantize == "bfloat16":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
    else:
        _check(got, want, quantize)
    assert not {3, 5, 70, 119} & set(got[1].ravel().tolist())
    # the store: tombstoned and excluded as the reference records them
    for store in (EmbeddingStore(str(tmp_path / "p"), DIM), JaxStore(str(tmp_path / "r"), DIM)):
        assert store.excluded_paths() == {paths[3], paths[70], paths[119]}
        assert store.tombstoned_paths() == {paths[3], paths[5], paths[70], paths[119]}
    # re-adding a tombstoned path makes a fresh live row
    assert port.add([paths[5]], emb[5:6]) == ref.add([paths[5]], emb[5:6]) == 1
    assert port.was_removed(paths[5]) is ref.was_removed(paths[5]) is False
    assert len(port) == len(ref) == 117 and port.live_paths() == ref.live_paths()


# ---- the engine: one sequence on one pair of engines ----------------------


def _photos(media, names, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(media, exist_ok=True)
    for name in names:
        # short side 28 = the tiny model's input: the resample is the identity
        h, w = (28, int(rng.integers(28, 60))) if rng.random() < 0.5 else (int(rng.integers(28, 60)), 28)
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(os.path.join(media, name))


class _Pair:
    """The reference engine and the port's over one photo directory."""

    def __init__(self, root, **flags):
        self.root = root
        self.media = os.path.join(root, "pics")
        self.common = dict(model_weights=os.path.join(root, "tiny.safetensors"), media_dir=self.media,
                           chunk_size=4, k=50, **flags)
        self.open()

    def open(self):
        with pytest.MonkeyPatch.context() as mp:  # one device: the port's path
            mp.setattr(ref_engine_mod, "make_mesh", lambda *a, **kw: None)
            self.ref = RefEngine(RefArgs(index_dir=os.path.join(self.root, "ref_idx"), **self.common))
        self.port = SearchEngine(ServerArgs(index_dir=os.path.join(self.root, "port_idx"), **self.common), device="cpu")

    def both(self, fn):
        a, b = fn(self.ref), fn(self.port)
        assert a == b
        return a

    def scan(self):
        r, p = self.ref.scan(), self.port.scan()
        got = (p.found, p.embedded, p.skipped_existing, p.decode_failures, p.pruned)
        assert got == (r.found, r.embedded, r.skipped_existing, r.decode_failures, r.pruned)
        return p

    def search(self, query="x", refs=()):
        want, got = self.ref.search(query, list(refs)), self.port.search(query, list(refs))
        assert [d["image_path"] for d in got] == [d["image_path"] for d in want]
        np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-5, rtol=0)
        return [d["image_path"] for d in got]

    def excluded(self):
        assert self.port._excluded == self.ref._excluded
        assert self.port.index.store.excluded_paths() == self.ref.index.store.excluded_paths()
        return self.port._excluded


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_remove"))
    names = [f"photo_{i}.png" for i in range(N_PHOTOS)] + ["my photo #1.png"]
    _photos(os.path.join(root, "pics"), names, seed=40)
    cfg = tiny_test_config()
    save_checkpoint(os.path.join(root, "tiny.safetensors"), jax_init_params(jax.random.key(6), cfg), cfg)
    pair = _Pair(root, prune_on_scan=True)
    stats = pair.scan()
    assert stats.embedded == N_PHOTOS + 1 and stats.pruned == 0
    return pair


def _counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


def test_remove_tombstones_and_excludes(pair):
    """Request duplicates and never-indexed paths do not become exclusions."""
    victim = pair.search()[0]
    before = _counter(ref_metrics, "removed_images"), _counter(global_metrics, "removed_images")
    assert pair.both(lambda e: e.remove_images([victim, victim, "media/never_indexed.jpg"])) == 1
    assert _counter(ref_metrics, "removed_images") - before[0] == _counter(global_metrics, "removed_images") - before[1] == 1
    assert pair.excluded() == {pair.port.to_abs_path(victim)}
    got = pair.search()
    assert victim not in got and len(got) == N_PHOTOS
    assert pair.both(lambda e: e.remove_images(["media/ghost.jpg", "not-media/x"])) == 0


def test_rescan_and_restart_keep_the_removed_photo_out(pair):
    victim = next(iter(pair.excluded()))
    stats = pair.scan()
    assert stats.embedded == 0 and stats.pruned == 0
    assert pair.port.to_media_path(victim) not in pair.search()
    pair.open()  # a restart over the same index directories
    assert pair.scan().embedded == 0
    assert pair.port.to_media_path(victim) not in pair.search()
    pair.excluded()


def test_restore_by_urlencoded_id_then_rescan(pair):
    """A photo removed by its urlencoded ``id`` restores the same way, and
    the next scan re-embeds it; restoring an unknown path clears nothing."""
    results = pair.port.search("y")
    target = next(d for d in results if "my photo #1" in d["image_path"])
    assert target["id"] != target["image_path"]  # really encoded
    assert pair.both(lambda e: e.remove_images([target["id"]])) == 1
    assert target["image_path"] not in pair.search("y")
    others = [pair.port.to_media_path(p) for p in pair.excluded() if "my photo" not in p]
    assert len(others) == 1
    assert pair.both(lambda e: e.restore_images([target["id"]] + others)) == 2
    assert pair.both(lambda e: e.restore_images(["media/ghost.jpg"])) == 0
    assert pair.excluded() == set()
    stats = pair.scan()
    assert stats.embedded == 2
    got = pair.search("y")
    assert target["image_path"] in got and len(got) == N_PHOTOS + 1


def test_prune_on_scan_and_remove_after_prune(pair):
    """--prune-on-scan tombstones a deleted file (no exclusion); when the
    file comes back, /remove of the now rowless path still excludes it, so
    no rescan (nor a restart) re-adds it."""
    other = pair.search()[1]
    abs_other = pair.port.to_abs_path(other)
    with open(abs_other, "rb") as f:
        data = f.read()
    os.remove(abs_other)
    before = _counter(ref_metrics, "pruned_missing"), _counter(global_metrics, "pruned_missing")
    stats = pair.scan()
    assert stats.pruned == 1 and stats.embedded == 0
    assert _counter(ref_metrics, "pruned_missing") - before[0] == _counter(global_metrics, "pruned_missing") - before[1] == 1
    assert other not in pair.search() and pair.excluded() == set()
    assert pair.both(lambda e: e.index.was_removed(abs_other)) is True
    with open(abs_other, "wb") as f:
        f.write(data)
    assert pair.both(lambda e: e.remove_images([other])) == 0  # no live row to remove
    assert pair.excluded() == {abs_other}
    assert pair.scan().embedded == 0
    assert other not in pair.search()


def test_remove_while_the_file_is_absent_still_excludes(pair):
    victim = pair.search()[0]
    abs_victim = pair.port.to_abs_path(victim)
    with open(abs_victim, "rb") as f:
        data = f.read()
    os.remove(abs_victim)
    assert pair.both(lambda e: e.prune_missing()) == 1
    assert pair.both(lambda e: e.remove_images([victim])) == 0
    assert abs_victim in pair.excluded()
    with open(abs_victim, "wb") as f:
        f.write(data)
    assert pair.scan().embedded == 0
    pair.open()  # the store's tombstone log carries it across a restart
    assert pair.scan().embedded == 0
    assert victim not in pair.search()


def test_prune_refuses_when_the_media_tree_is_unavailable(pair):
    """A missing directory, or one that yields no image while the index holds
    rows, is treated as unmounted: nothing is pruned."""
    n = len(pair.search())
    hidden = pair.media + ".away"
    os.rename(pair.media, hidden)
    try:
        assert pair.both(lambda e: e.prune_missing()) == 0
        os.makedirs(pair.media)
        assert pair.both(lambda e: e.prune_missing()) == 0
        assert len(pair.search()) == n
    finally:
        shutil.rmtree(pair.media, ignore_errors=True)
        os.rename(hidden, pair.media)


def test_exclusions_survive_compaction(pair):
    """Compacting either store (they are one format) keeps the exclusions."""
    excluded = pair.excluded()
    assert excluded
    cfg = tiny_test_config()
    EmbeddingStore(os.path.join(pair.root, "port_idx"), cfg.projection_dim).compact()
    JaxStore(os.path.join(pair.root, "ref_idx"), cfg.projection_dim).compact()
    pair.open()
    assert pair.excluded() == excluded
    assert pair.scan().embedded == 0
    pair.search()
