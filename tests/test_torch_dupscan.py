"""The port's corpus sketch, duplicate scans and duplicate-group routes against
the JAX package's, on the planted corpora of tests/test_dupscan.py.

The same numpy-seeded rows go into ``image_search_tpu.index.VectorIndex``
(its Pallas kernels in interpret mode, as its own tests run them) and into
the port's index on the CPU (kernels B3 and B4's plain versions). Pair sets
must be equal outside +-BAND of the threshold, where the two frameworks'
f32 sums may round a score across it, and the scores of common pairs agree
within 2e-4; the sketches agree within 1e-5.
"""

import numpy as np
import pytest
import torch

from image_search_tpu.index.dupscan import DupScanBailout as JaxBailout
from image_search_tpu.index.index import VectorIndex as JaxIndex
from image_search_tpu.server.engine import SearchEngine as RefEngine
from image_search_tpu.utils.metrics import global_metrics as ref_metrics
from image_search_tpu_torch.index.dupscan import DupScanBailout
from image_search_tpu_torch.index.index import VectorIndex
from image_search_tpu_torch.index.slabs import dequantized
from image_search_tpu_torch.server.engine import SearchEngine
from image_search_tpu_torch.utils.metrics import global_metrics
from test_dupscan import (
    BAND, DIM, check_band, concentrated, flat, plant_cross_block_dups, plant_dups,
)

SCORE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Each sketch build runs an f64 SVD of an 8,192-row sample in both
    packages, and the scans many small torch ops; under parallel test
    workers OpenBLAS's and torch's threads oversubscribe the cores and slow
    this file about six times over."""
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


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _indexes(emb, quantize=None, remove=(), **kw):
    paths = [f"p{i}" for i in range(len(emb))]
    ref = JaxIndex(DIM, quantize=quantize, **kw)
    port = VectorIndex(DIM, device="cpu", quantize=quantize, **kw)
    for idx in (ref, port):
        idx.add(paths, emb)
        idx.remove_paths(list(remove))
    return ref, port


def _stored(port):
    return dequantized(port._snapshot(), torch.arange(port._size)).numpy()


def assert_same_pairs(got, want, threshold):
    g = {(i, j): s for i, j, s in got}
    w = {(i, j): s for i, j, s in want}
    assert len(g) == len(got)  # each pair once
    assert {k for k, s in g.items() if abs(s - threshold) > BAND} <= set(w), sorted(set(g) - set(w))[:5]
    assert {k for k, s in w.items() if abs(s - threshold) > BAND} <= set(g), sorted(set(w) - set(g))[:5]
    assert all(abs(g[k] - w[k]) < SCORE_ATOL for k in set(g) & set(w))


def assert_same_sketch(ref, port):
    a, b = ref._sketch, port._sketch
    assert a.built_rows == b.built_rows
    np.testing.assert_allclose(b.basis.numpy(), np.asarray(a.basis), atol=1e-5)
    assert len(a.sketches) == len(b.sketches)
    for sa, sb, ra, rb in zip(a.sketches, b.sketches, a.resid, b.resid):
        assert sb.shape == sa.shape and str(sb.dtype).split(".")[-1] == str(sa.dtype)
        np.testing.assert_allclose(sb.float().numpy(), np.asarray(sa, np.float32), atol=1e-5)
        # t = sqrt(|r|^2 - |s|^2 + SLACK_T) takes the square root of a
        # difference of two ~1 sums (about 1e-5 on a concentrated corpus),
        # whose f32 rounding the two frameworks' summation orders move by
        # ~1e-7: compared as the square, which the bound's t_i * t_j uses
        np.testing.assert_allclose(rb.numpy() ** 2, np.asarray(ra) ** 2, atol=1e-5)
    np.testing.assert_allclose(float(b.ub_slack), float(a.ub_slack), atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sketch_matches_reference(rng, quantize, dtype):
    """build_sketch: fit_basis on the same row sample and sketch_slab over
    every slab, for f32 and bf16 sketches of f32 and int8 rows."""
    ref, port = _indexes(concentrated(rng, 3_000), quantize)
    for idx in (ref, port):
        idx.build_sketch(dtype=dtype)
    assert port.sketch_fresh
    assert_same_sketch(ref, port)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_certified_scan_matches_reference(rng, quantize):
    n, n_dups = 6_000, 40
    emb = plant_dups(rng, concentrated(rng, n), n_dups)
    ref, port = _indexes(emb, quantize)
    for idx in (ref, port):
        idx.build_sketch()
    got = port.find_near_duplicates_sketch(threshold=0.95)
    assert_same_pairs(got, ref.find_near_duplicates_sketch(threshold=0.95), 0.95)
    stored = _stored(port)
    check_band(got, stored, 0.95)
    planted = {
        (2 * p, 2 * p + 1) for p in range(n_dups)
        if float(stored[2 * p] @ stored[2 * p + 1]) >= 0.95 + BAND
    }
    assert planted and planted <= {(i, j) for i, j, _ in got}


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_candidate_scan_matches_reference(rng, quantize):
    """A flat corpus where the certified scan bails out in both packages;
    the approximate scan finds every planted pair, in-block and across."""
    n, thr = 8_192, 0.5
    cross = [(100, 4_500), (200, 7_300), (1_000, 2_222)]
    emb = plant_cross_block_dups(rng, plant_dups(rng, flat(rng, n), 20), cross)
    ref, port = _indexes(emb, quantize)
    for idx in (ref, port):
        idx.build_sketch()
    with pytest.raises(JaxBailout):
        ref.find_near_duplicates_sketch(threshold=thr)
    with pytest.raises(DupScanBailout):
        port.find_near_duplicates_sketch(threshold=thr)
    got = port.find_near_duplicates_candidates(threshold=thr)
    assert_same_pairs(got, ref.find_near_duplicates_candidates(threshold=thr), thr)
    planted = {(2 * p, 2 * p + 1) for p in range(20)} | set(cross)
    assert planted <= {(i, j) for i, j, _ in got}


def test_tombstoned_rows_excluded_like_reference(rng):
    emb = plant_dups(rng, concentrated(rng, 3_000), 20)
    ref, port = _indexes(emb, remove=["p0", "p5"])  # kills pairs (0, 1) and (4, 5)
    for idx in (ref, port):
        idx.build_sketch()
    got = port.find_near_duplicates_sketch(threshold=0.95)
    assert_same_pairs(got, ref.find_near_duplicates_sketch(threshold=0.95), 0.95)
    assert not {0, 5} & {i for p in got for i in p[:2]}
    live = np.ones(3_000, bool)
    live[[0, 5]] = False
    check_band(got, _stored(port), 0.95, live)
    got_c = port.find_near_duplicates_candidates(threshold=0.95)
    assert_same_pairs(got_c, ref.find_near_duplicates_candidates(threshold=0.95), 0.95)
    assert not {0, 5} & {i for p in got_c for i in p[:2]}


def test_multi_slab_corpus_like_reference(rng):
    n, slab = 5_000, 4_096
    emb = concentrated(rng, n)
    v = emb[100] + 0.005 * rng.normal(size=DIM).astype(np.float32)
    emb[4_500] = (v / np.linalg.norm(v)).astype(np.float32)  # across the slab boundary
    ref, port = _indexes(emb, slab_rows=slab, min_capacity=slab)
    assert len(port._emb_slabs) == len(ref._emb_slabs) > 1
    for idx in (ref, port):
        idx.build_sketch()
    assert_same_sketch(ref, port)
    got = port.find_near_duplicates_sketch(0.99)
    assert (100, 4_500) in {(i, j) for i, j, _ in got}
    assert_same_pairs(got, ref.find_near_duplicates_sketch(0.99), 0.99)
    check_band(got, _stored(port), 0.99)


def test_flat_corpus_bails_out_like_reference(rng):
    ref, port = _indexes(flat(rng, 8_192))
    for idx in (ref, port):
        idx.build_sketch()
    got = port.find_near_duplicates_sketch(threshold=0.95)
    assert_same_pairs(got, ref.find_near_duplicates_sketch(threshold=0.95), 0.95)
    check_band(got, _stored(port), 0.95)
    with pytest.raises(JaxBailout):
        ref.find_near_duplicates_sketch(threshold=0.5)
    with pytest.raises(DupScanBailout, match="budget"):
        port.find_near_duplicates_sketch(threshold=0.5)


def test_threshold_below_slack_refused(rng):
    ref, port = _indexes(concentrated(rng, 512))
    for idx in (ref, port):
        idx.build_sketch()
    with pytest.raises(JaxBailout):
        ref.find_near_duplicates_sketch(threshold=1e-5)
    with pytest.raises(DupScanBailout, match="slack"):
        port.find_near_duplicates_sketch(threshold=1e-5)


@pytest.mark.parametrize("scan", ["find_near_duplicates_sketch", "find_near_duplicates_candidates"])
def test_progress_monotone_and_complete(rng, scan):
    port = VectorIndex(DIM, device="cpu")
    port.add([f"p{i}" for i in range(2_048)], plant_dups(rng, concentrated(rng, 2_048), 10))
    port.build_sketch()
    seen = []
    getattr(port, scan)(threshold=0.95, progress=lambda a, b: seen.append(a / b))
    assert seen and seen[-1] == 1.0 and seen == sorted(seen)


@pytest.mark.parametrize("n0,n1", [(512, 1), (8_000, 500)])
def test_incremental_sketch_matches_reference(rng, n0, n1):
    """Appends keep the sketch fresh exactly as the reference's do, also
    when the first slab doubles under the append (8,192 -> 16,384 rows): the
    sketch slab is zero-padded to the new geometry and the new rows are
    sketched against the existing basis."""
    ref, port = _indexes(concentrated(rng, n0))
    for idx in (ref, port):
        idx.build_sketch()
        with pytest.raises(JaxBailout if idx is ref else DupScanBailout):
            idx._sketch = idx._sketch._replace(built_rows=idx._sketch.built_rows - 1)
            idx.find_near_duplicates_sketch()  # a stale sketch bails out
        idx._sketch = idx._sketch._replace(built_rows=idx._sketch.built_rows + 1)
    cap0 = port.capacity
    extra = concentrated(rng, n1)
    extra[0] = _stored(port)[3]  # the first new row duplicates row 3
    for idx in (ref, port):
        idx.add([f"x{i}" for i in range(n1)], extra)
        assert idx.sketch_fresh and idx.sketch_incremental == 1
    assert (port.capacity > cap0) == (n0 + n1 > cap0)
    assert_same_sketch(ref, port)
    got = port.find_near_duplicates_sketch(0.99)
    assert (3, n0) in {(i, j) for i, j, _ in got}
    assert_same_pairs(got, ref.find_near_duplicates_sketch(0.99), 0.99)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_legacy_scan_matches_reference(rng, quantize):
    emb = plant_dups(rng, concentrated(rng, 2_048), 12)
    ref, port = _indexes(emb, quantize, remove=["p2"])
    got = port.find_near_duplicates(threshold=0.95, batch=512)
    assert_same_pairs(got, ref.find_near_duplicates(threshold=0.95, batch=512), 0.95)
    assert {(2 * p, 2 * p + 1) for p in range(12) if p != 1} <= {(i, j) for i, j, _ in got}


def _engines(ref_idx, port_idx, args=None):
    ref = RefEngine.__new__(RefEngine)  # routing only: no model needed
    port = SearchEngine.__new__(SearchEngine)
    for eng, idx in ((ref, ref_idx), (port, port_idx)):
        eng.index = idx
        eng.args = type("A", (), args or {})()
        eng.media_dir = "."
    return ref, port


def _same_groups(ref, port, threshold):
    want = {tuple(g) for g in ref.find_duplicate_groups(threshold=threshold)}
    got = {tuple(g) for g in port.find_duplicate_groups(threshold=threshold)}
    assert got == want and want
    assert port.last_duplicate_mode == ref.last_duplicate_mode
    gauges = global_metrics.snapshot()["gauges"]
    ref_gauges = ref_metrics.snapshot()["gauges"]
    for name in ("duplicate_scan_progress", "duplicate_scan_sketch", "duplicate_scan_certified"):
        assert gauges[name] == ref_gauges[name], name
    return port.last_duplicate_mode


def test_engine_routes_match_reference(rng, monkeypatch):
    """certified with a fresh sketch; legacy_exact after a forced bailout
    below the approximate cut; approximate above it, reusing the published
    sketch."""
    emb = plant_dups(rng, concentrated(rng, 2_048), 8)
    ref_idx, port_idx = _indexes(emb)
    for idx in (ref_idx, port_idx):
        idx.build_sketch()
    ref, port = _engines(ref_idx, port_idx)
    assert _same_groups(ref, port, 0.95) == "certified"

    def bail(self, **kw):
        raise DupScanBailout("forced")

    def ref_bail(self, **kw):
        raise JaxBailout("forced")

    monkeypatch.setattr(VectorIndex, "find_near_duplicates_sketch", bail)
    monkeypatch.setattr(JaxIndex, "find_near_duplicates_sketch", ref_bail)
    assert _same_groups(ref, port, 0.95) == "legacy_exact"
    for eng in (RefEngine, SearchEngine):
        monkeypatch.setattr(eng, "DUPLICATES_APPROX_ABOVE", 1_000)
    assert _same_groups(ref, port, 0.95) == "approximate"
    assert port_idx.sketch_fresh and ref_idx.sketch_fresh  # the published sketch stays


def test_engine_drops_ungated_sketch_like_reference(rng, monkeypatch):
    """A flat corpus over both cuts: the certifiability gate refuses the
    sketch, the approximate scan builds an ungated one and drops it after."""
    emb = plant_dups(rng, flat(rng, 4_096), 10)
    ref_idx, port_idx = _indexes(emb)
    ref, port = _engines(ref_idx, port_idx, {"twostage_min_certifiable": 1.01})
    for eng in (RefEngine, SearchEngine):
        monkeypatch.setattr(eng, "DUPLICATES_SKETCH_ABOVE", 1_000)
        monkeypatch.setattr(eng, "DUPLICATES_APPROX_ABOVE", 1_000)
    assert _same_groups(ref, port, 0.5) == "approximate"
    assert not port_idx.sketch_fresh and not ref_idx.sketch_fresh
    assert port_idx.twostage_gate_skips == ref_idx.twostage_gate_skips == 1
    assert port_idx.sketch_certifiable_est == pytest.approx(ref_idx.sketch_certifiable_est, abs=1e-6)


def test_bf16_sketch_certified_scan_matches_reference(rng):
    emb = plant_dups(rng, concentrated(rng, 4_000), 25)
    ref, port = _indexes(emb)
    for idx in (ref, port):
        idx.build_sketch(dtype="bfloat16")
    got = port.find_near_duplicates_sketch(threshold=0.95)
    assert_same_pairs(got, ref.find_near_duplicates_sketch(threshold=0.95), 0.95)
    check_band(got, _stored(port), 0.95)
