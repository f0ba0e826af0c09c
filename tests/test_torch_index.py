"""The port's VectorIndex against the JAX package's on the same rows.

f32 rows: scores within rtol 1e-5 (the reference's own bound), ids equal.
int8 rows: scores BITWISE equal and ids equal where the scores are distinct.
For that the inputs are built so that every reduction whose order differs
between XLA and torch is exact: rows are integer vectors with one entry at
+-127 and a squared norm of exactly 4^8, so the stored int8 row IS the
vector and its scale and norm are powers of two; queries are small
integers. Then the query norms, the Rocchio sums and everything after them
are exact in any order, and what is left to compare is the algorithm.
"""

import numpy as np
import pytest
import torch

from image_search_tpu.index import EmbeddingStore as JaxStore
from image_search_tpu.index import VectorIndex as JaxIndex
from image_search_tpu_torch.index.index import EmbeddingStore, VectorIndex

DIM = 64


def make_data(rng, n, dim=DIM):
    emb = rng.normal(size=(n, dim)).astype(np.float32) * rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    return [f"/pics/img_{i:05d}.jpg" for i in range(n)], emb


_TWO_SQUARES = {a * a + b * b: (a, b) for a in range(128) for b in range(a, 128)}


def _three_squares(r):
    """(a, b, c) with a^2 + b^2 + c^2 == r and each <= 127, or None."""
    for c in range(128):
        ab = _TWO_SQUARES.get(r - c * c)
        if ab is not None:
            return (*ab, c)
    return None


def exact_rows(rng, n, dim=DIM):
    """Integer rows with max |e| = 127 and sum(e^2) = 65536 (norm 256)."""
    out = np.zeros((n, dim), np.float32)
    for i in range(n):
        while True:
            e = rng.integers(-20, 21, size=dim - 4)
            abc = _three_squares(65536 - 127 * 127 - int((e * e).sum()))
            if abc is not None:
                break
        row = np.concatenate([[127], e, abc]) * rng.choice([-1, 1], size=dim)
        out[i] = rng.permutation(row)
    assert np.all(np.linalg.norm(out, axis=1) == 256.0)
    return [f"/pics/exact_{i:05d}.jpg" for i in range(n)], out


def int_queries(rng, b, dim=DIM):
    return rng.integers(-8, 9, size=(b, dim)).astype(np.float32)


def _check(got, want, quantize):
    gs, gi = got
    ws, wi = want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    if quantize == "int8":
        np.testing.assert_array_equal(gs, ws)
        for b in range(gs.shape[0]):
            vals, counts = np.unique(gs[b], return_counts=True)
            distinct = np.isin(gs[b], vals[counts == 1])
            np.testing.assert_array_equal(gi[b][distinct], wi[b][distinct])
    else:
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(gi, wi)


def _pair(quantize, paths, emb, **kw):
    port = VectorIndex(DIM, device="cpu", quantize=quantize, **kw)
    ref = JaxIndex(DIM, quantize=quantize, **kw)
    assert port.add(paths, emb) == ref.add(paths, emb) == len(paths)
    return port, ref


def _data(quantize, rng, n):
    return exact_rows(rng, n) if quantize == "int8" else make_data(rng, n)


def _queries(quantize, rng, b):
    return int_queries(rng, b) if quantize == "int8" else rng.normal(size=(b, DIM)).astype(np.float32)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_search_matches_reference(quantize):
    rng = np.random.default_rng(1)
    paths, emb = _data(quantize, rng, 300)
    port, ref = _pair(quantize, paths, emb)
    q = _queries(quantize, rng, 5)
    _check(port.search(q, k=20), ref.search(q, k=20), quantize)
    _check(port.search(q[0], k=1000), ref.search(q[0], k=1000), quantize)  # k clamped


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_feedback_batch_matches_reference(quantize):
    rng = np.random.default_rng(2)
    paths, emb = _data(quantize, rng, 200)
    port, ref = _pair(quantize, paths, emb)
    texts = _queries(quantize, rng, 5)
    # at most two marked rows each: their sum is one rounding, in any order
    sels = [paths[:2], [], [paths[50]], ["/unknown.jpg"], [paths[7], "/unknown.jpg", paths[9]]]
    _check(
        port.search_with_feedback_batch(texts, sels, k=15),
        ref.search_with_feedback_batch(texts, sels, k=15),
        quantize,
    )
    _check(
        port.search_with_feedback(texts[0], paths[3:5], k=15),
        ref.search_with_feedback(texts[0], paths[3:5], k=15),
        quantize,
    )


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_feedback_many_marked_close_to_reference(quantize):
    """More marked rows: the Rocchio mean sums in another order, so the
    refined query may differ in its last bits; ids still agree."""
    rng = np.random.default_rng(3)
    paths, emb = make_data(rng, 200)
    port, ref = _pair(quantize, paths, emb)
    texts = rng.normal(size=(2, DIM)).astype(np.float32)
    sels = [paths[10:25], paths[100:106]]
    gs, gi = port.search_with_feedback_batch(texts, sels, k=10)
    ws, wi = ref.search_with_feedback_batch(texts, sels, k=10)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_empty_selection_equals_plain_search_bitwise(quantize):
    rng = np.random.default_rng(4)
    paths, emb = make_data(rng, 150)
    port = VectorIndex(DIM, device="cpu", quantize=quantize)
    port.add(paths, emb)
    texts = rng.normal(size=(3, DIM)).astype(np.float32)
    fs, fi = port.search_with_feedback_batch(texts, [[], ["/unknown.jpg"], []], k=12)
    ps, pi = port.search(texts, k=12)
    np.testing.assert_array_equal(fs, ps)
    np.testing.assert_array_equal(fi, pi)
    # one query alone: the same as its own plain search (an f32 matmul may
    # sum differently at another batch size, so compare at B=1)
    ss, si = port.search_with_feedback(texts[1], ["/unknown.jpg"], k=12)
    os_, oi = port.search(texts[1], k=12)
    np.testing.assert_array_equal(ss, os_)
    np.testing.assert_array_equal(si, oi)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_store_written_by_reference_opens_with_same_topk(quantize, tmp_path):
    rng = np.random.default_rng(5)
    paths, emb = _data(quantize, rng, 120)
    ref = JaxIndex(DIM, quantize=quantize, store=JaxStore(str(tmp_path), DIM))
    ref.add(paths[:70], emb[:70])
    ref.add(paths[70:], emb[70:])
    dead = [paths[3], paths[71], paths[110]]
    assert ref.remove_paths(dead) == 3
    port = VectorIndex.from_store(EmbeddingStore(str(tmp_path), DIM), device="cpu", quantize=quantize)
    reopened = JaxIndex.from_store(JaxStore(str(tmp_path), DIM), quantize=quantize)
    assert len(port) == len(reopened) == 117
    assert not any(port.has_path(p) for p in dead)
    q = _queries(quantize, rng, 4)
    _check(port.search(q, k=30), reopened.search(q, k=30), quantize)
    got_paths = [port.paths[i] for i in port.search(q, k=30)[1].ravel()]
    assert got_paths == reopened.paths_for(reopened.search(q, k=30)[1])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_tombstoned_rows_never_returned(quantize, tmp_path):
    rng = np.random.default_rng(6)
    paths, emb = make_data(rng, 60)
    store = EmbeddingStore(str(tmp_path), DIM)
    port = VectorIndex(DIM, device="cpu", quantize=quantize, store=store)
    port.add(paths, emb)
    target = emb[9]
    assert port.search(target, k=1)[1][0, 0] == 9
    assert port.remove_paths([paths[9], paths[9], "/never.jpg"]) == 1
    assert len(port) == 59 and not port.has_path(paths[9])
    s, i = port.search(target, k=60)
    assert 9 not in i[0][s[0] > -1e30]
    # a tombstoned selection is skipped like an unknown path
    fs, fi = port.search_with_feedback(target, [paths[9]], k=5)
    ps, pi = port.search(target, k=5)
    np.testing.assert_array_equal(fs, ps)
    # and stays removed across a restart
    again = VectorIndex.from_store(EmbeddingStore(str(tmp_path), DIM), device="cpu", quantize=quantize)
    assert len(again) == 59 and not again.has_path(paths[9])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_slab_growth_matches_reference(quantize):
    """Small slabs force the doubling first slab and then whole new slabs;
    global ids and answers stay the reference's."""
    rng = np.random.default_rng(7)
    paths, emb = _data(quantize, rng, 9000) if quantize is None else exact_rows(rng, 300)
    if quantize == "int8":  # many rows, few distinct exact ones: tile them
        emb = np.tile(emb, (30, 1))
        paths = [f"/pics/t_{i:05d}.jpg" for i in range(len(emb))]
    kw = dict(min_capacity=4096, slab_rows=4096)
    port = VectorIndex(DIM, device="cpu", quantize=quantize, **kw)
    ref = JaxIndex(DIM, quantize=quantize, **kw)
    for lo, hi in ((0, 1000), (1000, 5000), (5000, len(paths))):
        port.add(paths[lo:hi], emb[lo:hi])
        ref.add(paths[lo:hi], emb[lo:hi])
    assert port.capacity == ref.capacity and len(port._emb_slabs) == len(ref._emb_slabs) >= 3
    q = _queries(quantize, rng, 3)
    _check(port.search(q, k=25), ref.search(q, k=25), quantize)
    np.testing.assert_array_equal(
        port.get_raw_embeddings(paths[4090:4100] + paths[-3:]),
        ref.get_raw_embeddings(paths[4090:4100] + paths[-3:]),
    )


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_raw_embeddings_and_dedup(quantize):
    rng = np.random.default_rng(8)
    paths, emb = make_data(rng, 40)
    port, ref = _pair(quantize, paths, emb)
    assert port.add(paths[:5] + ["/new.jpg", "/new.jpg"], np.concatenate([emb[:5], emb[:2]])) == 1
    ref.add(paths[:5] + ["/new.jpg", "/new.jpg"], np.concatenate([emb[:5], emb[:2]]))
    sel = [paths[0], "/missing.jpg", paths[17], "/new.jpg"]
    got, want = port.get_raw_embeddings(sel), ref.get_raw_embeddings(sel)
    assert got.shape == (3, DIM)
    np.testing.assert_array_equal(got, want)
    assert port.paths == ref.paths and len(port) == 41


def test_empty_index_and_unsupported_options():
    port = VectorIndex(DIM, device="cpu")
    s, i = port.search(np.ones(DIM, np.float32), k=5)
    assert s.shape == (1, 0) and i.shape == (1, 0)
    s, i = port.search_with_feedback_batch(np.ones((2, DIM), np.float32), [[], []], k=5)
    assert s.shape == (2, 0)
    # bf16 rows and the approximate search are ported: an empty index answers empty
    s, i = VectorIndex(DIM, device="cpu", quantize="bfloat16").search(np.ones(DIM, np.float32), k=5)
    assert s.shape == (1, 0) and i.shape == (1, 0)
    s, i = port.search(np.ones(DIM, np.float32), k=5, approx=True)
    assert s.shape == (1, 0) and i.shape == (1, 0)
    with pytest.raises(NotImplementedError):
        VectorIndex(DIM, device="cpu", mesh=object())
    with pytest.raises(ValueError):
        VectorIndex(DIM, device="cpu", quantize="int4")


def test_device_tensor_queries_are_accepted():
    """The engine chains the text tower's device output straight into the
    search; a tensor query gives the numpy query's answer."""
    rng = np.random.default_rng(9)
    paths, emb = make_data(rng, 50)
    port = VectorIndex(DIM, device="cpu", quantize="int8")
    port.add(paths, emb)
    q = rng.normal(size=(2, DIM)).astype(np.float32)
    a = port.search_with_feedback_batch(torch.from_numpy(q).bfloat16(), [[], [paths[1]]], k=7)
    b = port.search_with_feedback_batch(torch.from_numpy(q).bfloat16().float().numpy(), [[], [paths[1]]], k=7)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_preallocated_capacity_matches_reference(quantize):
    """--index-capacity: every slab exists up front, as in the reference,
    and appends then allocate nothing."""
    rng = np.random.default_rng(10)
    paths, emb = make_data(rng, 5000)
    kw = dict(min_capacity=4096, slab_rows=4096, capacity=10_000)
    port = VectorIndex(DIM, device="cpu", quantize=quantize, **kw)
    ref = JaxIndex(DIM, quantize=quantize, **kw)
    slabs = [s.data_ptr() for s in port._emb_slabs]
    assert port.capacity == ref.capacity >= 10_000 and len(slabs) == len(ref._emb_slabs)
    port.add(paths, emb)
    ref.add(paths, emb)
    assert [s.data_ptr() for s in port._emb_slabs] == slabs
    q = rng.normal(size=(2, DIM)).astype(np.float32)
    gs, gi = port.search(q, k=10)
    ws, wi = ref.search(q, k=10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)


def _tied_corpus(rng, quantize, copies=5, distinct=40):
    """``distinct`` exact rows (exact_rows: every f32 and int8 score is exact
    in any summation order), each stored ``copies`` times at shuffled
    positions: duplicated photos, whose scores tie exactly in both packages."""
    paths, emb = exact_rows(rng, distinct)
    order = rng.permutation(distinct * copies)
    emb = np.repeat(emb, copies, axis=0)[order]
    return [f"/pics/dup_{i:05d}.jpg" for i in range(len(emb))], emb


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("k", [1, 12, 37, 200])
def test_search_ties_match_reference_ids(quantize, k):
    """Duplicated rows: values AND ids equal the reference's, in its order,
    also where the k boundary cuts through a group of copies."""
    rng = np.random.default_rng(20 + k)
    paths, emb = _tied_corpus(rng, quantize)
    port, ref = _pair(quantize, paths, emb)
    _, q = exact_rows(rng, 3)
    (gs, gi), (ws, wi) = port.search(q, k=k), ref.search(q, k=k)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gi, wi)
    assert k == 1 or (np.diff(gs, axis=1) == 0).any()  # the ties are there
    sels = [[paths[0]], [], [paths[3], paths[9]]]
    (gs, gi), (ws, wi) = (ix.search_with_feedback_batch(q, sels, k=k) for ix in (port, ref))
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize(
    "budget,grows", [(None, True), ("0", True), ("-1", True), ("0.005", False), ("0.01", True)]
)
def test_hbm_budget_switch_matches_reference(monkeypatch, budget, grows):
    """ISX_INDEX_HBM_BUDGET_GB read as the reference reads it: set, it
    replaces the 85% budget on any device (<= 0 turns it off); unset, the CPU
    is never blocked. Growth to 24,576 rows of 264 bytes (6.5 MB) and a
    20,000-row preallocation (5.3 MB) pass or raise alike in both packages."""
    if budget is None:
        monkeypatch.delenv("ISX_INDEX_HBM_BUDGET_GB", raising=False)
    else:
        monkeypatch.setenv("ISX_INDEX_HBM_BUDGET_GB", budget)
    paths, emb = make_data(np.random.default_rng(6), 9000)
    for make in (lambda **kw: VectorIndex(DIM, device="cpu", **kw), lambda **kw: JaxIndex(DIM, **kw)):
        ix = make()
        if grows:
            assert ix.add(paths, emb) == 9000
        else:
            with pytest.raises(RuntimeError, match="ISX_INDEX_HBM_BUDGET_GB"):
                ix.add(paths, emb)
        if grows:
            assert make(capacity=20_000).capacity >= 20_000
        else:
            with pytest.raises(RuntimeError, match="ISX_INDEX_HBM_BUDGET_GB"):
                make(capacity=20_000)


# ---- bf16 rows (--index-quantize bfloat16) and approx=True (--search-approx) ----


def _bf16_check(got, want, tol=1e-6):
    """bf16 rows: the query cast to bf16, exact products summed in f32 in
    either framework's order -> scores within ``tol``; ids equal wherever no
    neighbour lies within ``tol``."""
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == np.float32 and gs.shape == ws.shape
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    for b in range(gs.shape[0]):
        d = np.abs(np.diff(gs[b]))
        apart = np.ones(gs.shape[1], bool)
        apart[1:] &= d > tol
        apart[:-1] &= d > tol
        np.testing.assert_array_equal(gi[b][apart], wi[b][apart])


def test_bf16_rows_match_reference(tmp_path):
    """Rows rounded to bf16 on the host as the reference rounds them; plain
    and Rocchio searches; a store written by the reference reopens as bf16
    with the same answers."""
    rng = np.random.default_rng(40)
    paths, emb = make_data(rng, 700)
    port, ref = _pair("bfloat16", paths, emb)
    assert port._emb_slabs[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(port.get_raw_embeddings(paths[:9]), ref.get_raw_embeddings(paths[:9]))
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    _bf16_check(port.search(q, k=40), ref.search(q, k=40))
    sels = [paths[:2], [], [paths[50]], ["/unknown.jpg"], paths[100:106]]
    _bf16_check(port.search_with_feedback_batch(q, sels, k=40), ref.search_with_feedback_batch(q, sels, k=40))
    store = JaxIndex(DIM, quantize="bfloat16", store=JaxStore(str(tmp_path), DIM))
    store.add(paths[:300], emb[:300])
    reopened = VectorIndex.from_store(EmbeddingStore(str(tmp_path), DIM), device="cpu", quantize="bfloat16")
    _bf16_check(reopened.search(q, k=40), store.search(q, k=40))


def test_bf16_sketch_and_twostage_take_bf16_rows():
    """The sketch build and the certified two-stage search read bf16 slabs
    (the rescore casts the query to bf16, as the full scan does) and answer
    as the full scan."""
    rng = np.random.default_rng(41)
    mix = rng.normal(size=(8, DIM))
    emb = (rng.normal(size=(9000, 8)) @ mix + 0.01 * rng.normal(size=(9000, DIM))).astype(np.float32)
    paths = [f"/pics/c_{i:05d}.jpg" for i in range(len(emb))]
    port = VectorIndex(DIM, device="cpu", quantize="bfloat16", min_capacity=4096, slab_rows=4096)
    port.add(paths, emb)
    port.build_sketch()
    assert port.sketch_fresh
    q = (rng.normal(size=(2, 8)) @ mix).astype(np.float32)
    full = port.search(q, k=20)
    got = port.search_twostage(q, k=20, candidates=512)
    np.testing.assert_allclose(got[0], full[0], rtol=0, atol=1e-6)
    assert port.twostage_certified == 1


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_approx_search_takes_lax_top_k_order(quantize):
    """approx=True: off the TPU the reference's ``approx_max_k`` returns
    ``lax.top_k``'s order. 262,144 rows (above exact_topk's two-level
    threshold) of 64 distinct exact rows, so most scores tie: values and ids
    equal the reference's, for the plain and the Rocchio search. The queries'
    own rows are rare, so the 128-row blocks' maxima differ and the exact
    path's two-level order (blocks by their maximum) is another order of the
    same values."""
    rng = np.random.default_rng(42)
    _, base = exact_rows(rng, 64)
    p = np.full(64, 1.0)
    p[:2] = 0.02  # the queries' own rows: in about one block in forty
    emb = base[rng.choice(64, size=262_144, p=p / p.sum())]
    paths = [f"/pics/a_{i:06d}.jpg" for i in range(len(emb))]
    port, ref = _pair(quantize, paths, emb)
    q = base[:2]
    got, want = port.search(q, k=1000, approx=True), ref.search(q, k=1000, approx=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    exact = port.search(q, k=1000)
    np.testing.assert_array_equal(exact[0], got[0])
    assert not np.array_equal(exact[1], got[1])
    # a marked row: the query's own copies and the marked row's copies then
    # tie in exact arithmetic (every row has norm 256), so only int8 scores,
    # exact in both packages, order those groups alike
    sels = [[paths[7]], []]
    got = port.search_with_feedback_batch(q, sels, k=300, approx=True)
    if quantize == "int8":
        want = ref.search_with_feedback_batch(q, sels, k=300, approx=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], port.search_with_feedback_batch(q, sels, k=300)[0])
