"""The port's certified two-stage search against the JAX package's.

The same numpy-seeded rows go into ``image_search_tpu.index.VectorIndex``
and into the port's index on the CPU (kernel B2's plain version), both build
their sketches, and each case calls the same entry point on both:

- the port's two-stage answer equals the port's own full scan (int8: scores
  bitwise, f32: ids equal and scores within 2e-6, the reference's own test
  tolerance);
- it equals the reference's two-stage answer: scores within 1e-6 (the two
  frameworks normalise queries with sums in different orders, so a score
  can differ in its last bits) and ids equal index for index wherever the
  score is more than 2e-6 from its neighbours' (closer ones may swap, as
  the two full scans swap them); where the rows are exact integers (the
  tie case) scores are bitwise and ids equal everywhere;
- the certified and fallback counters move alike in both packages.

Sizes are the reference's cases cut down (DIM 256, at most 20,000 rows),
module-scoped corpora, one thread for OpenBLAS and torch.
"""

import numpy as np
import pytest
import torch

from image_search_tpu.index import twostage as jts
from image_search_tpu.index.index import VectorIndex as JaxIndex
from image_search_tpu_torch.index import twostage
from image_search_tpu_torch.index.index import VectorIndex
from image_search_tpu_torch.ops.score_stream import quantize_queries_int8, scores_int8_reference
from test_torch_index import exact_rows, int_queries

DIM = 256
RANK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Sketch builds run f64 SVDs and the searches many small ops; under
    parallel test workers OpenBLAS's and torch's threads would
    oversubscribe the cores."""
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


def concentrated(rng, n, noise=0.02, dim=DIM):
    """Low-rank + noise rows: the spectral shape real embeddings have."""
    m = rng.normal(size=(RANK, dim))
    x = rng.normal(size=(n, RANK)) @ m + noise * rng.normal(size=(n, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def flat(rng, n):
    x = rng.normal(size=(n, DIM))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _pair(emb, quantize=None, sketch="float32", paths=None, **kw):
    """(reference, port) over the same rows, sketches built (None: not)."""
    paths = paths or [f"p{i}" for i in range(len(emb))]
    ref = JaxIndex(emb.shape[1], quantize=quantize, **kw)
    port = VectorIndex(emb.shape[1], device="cpu", quantize=quantize, **kw)
    for ix in (ref, port):
        ix.add(paths, emb)
        if sketch is not None:
            ix.build_sketch(dtype=sketch)
    return ref, port


def _counts(ix):
    return ix.twostage_certified, ix.twostage_fallbacks


def both(ref, port, method, *args, **kw):
    """Call ``method`` on both indexes -> (ref answer, port answer, the
    (certified, fallbacks) counter change), the changes required equal."""
    before = _counts(ref), _counts(port)
    want = getattr(ref, method)(*args, **kw)
    got = getattr(port, method)(*args, **kw)
    d_ref = tuple(a - b for a, b in zip(_counts(ref), before[0]))
    d_port = tuple(a - b for a, b in zip(_counts(port), before[1]))
    assert d_port == d_ref, (d_port, d_ref)
    return np.asarray(want[0]), np.asarray(want[1]), got, d_port


def assert_same(got, want, bitwise):
    gs, gi = (np.asarray(a) for a in got)
    ws, wi = (np.asarray(a) for a in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    if bitwise:
        np.testing.assert_array_equal(gs, ws)
    else:
        np.testing.assert_allclose(gs, ws, rtol=0, atol=2e-6)


def assert_like_reference(got, ws, wi, atol=1e-6):
    gs, gi = (np.asarray(a) for a in got)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
    pad = np.full((ws.shape[0], 1), np.inf)
    gaps = np.abs(np.diff(np.concatenate([pad, ws, -pad], axis=1), axis=1))
    isolated = np.minimum(gaps[:, :-1], gaps[:, 1:]) > 2 * atol
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


def check_search(ref, port, q, k, **kw):
    """search_twostage on both: port == port's full scan, like the
    reference's answer. -> the counter change."""
    ws, wi, got, delta = both(ref, port, "search_twostage", q, k, **kw)
    assert_same(got, port.search(q, k), bitwise=port.quantize == "int8")
    assert_like_reference(got, ws, wi)
    return delta


@pytest.fixture(scope="module", params=[None, "int8"], ids=["f32", "int8"])
def conc(request):
    rng = np.random.default_rng(0)
    emb = concentrated(rng, 20_000)
    ref, port = _pair(emb, request.param)
    return ref, port, emb, rng


def test_certified_exact_on_concentrated_corpus(conc):
    ref, port, _, rng = conc
    assert port.sketch_fresh and ref.sketch_fresh
    assert check_search(ref, port, concentrated(rng, 4), 100, candidates=512) == (1, 0)


def test_certified_success_resets_the_failure_count(conc):
    ref, port, _, rng = conc
    for ix in (ref, port):
        ix._twostage_consec_failures = VectorIndex.TWOSTAGE_DISABLE_AFTER - 1
    assert check_search(ref, port, concentrated(rng, 4), 100, candidates=512) == (1, 0)
    assert port._twostage_consec_failures == ref._twostage_consec_failures == 0


def test_feedback_twostage_equals_the_feedback_full_scan(conc):
    ref, port, _, rng = conc
    q = concentrated(rng, 2)
    sels = [["p3", "p17", "p400"], ["p8"]]
    ws, wi, got, delta = both(ref, port, "search_twostage_feedback_batch", q, sels, 100, candidates=512)
    assert delta == (1, 0)
    assert_same(got, port.search_with_feedback_batch(q, sels, 100), bitwise=port.quantize == "int8")
    assert_like_reference(got, ws, wi)
    # empty selections: the plain two-stage search, bitwise; unknown paths are dropped
    plain = port.search_twostage(q, 100, candidates=512)
    for sel in ([[], []], [["nope"], []]):
        got = port.search_twostage_feedback_batch(q, sel, 100, candidates=512)
        np.testing.assert_array_equal(got[0], plain[0])
        np.testing.assert_array_equal(got[1], plain[1])


def test_batched_union_identical_queries_give_no_duplicate_ids(conc):
    ref, port, _, rng = conc
    q = np.repeat(concentrated(rng, 1), 4, axis=0)
    assert check_search(ref, port, q, 100, candidates=512) == (1, 0)
    got = port.search_twostage(q, 100, candidates=512)
    assert all(len(set(row.tolist())) == 100 for row in got[1])


def test_batched_guard_falls_back_below_the_union_share():
    """16 queries: m = 63 of 64 blocks passes the solo guard, but each query
    is sure of only m // 16 = 3 blocks = 384 rows < k."""
    rng = np.random.default_rng(2)
    ref, port = _pair(concentrated(rng, 2_000))
    assert check_search(ref, port, concentrated(rng, 16), 1000, candidates=16) == (0, 1)


def test_batched_union_distinct_clusters_certify():
    rng = np.random.default_rng(3)
    n_half = 10_000
    base_a = np.zeros(DIM)
    base_a[:RANK] = 1.0
    base_b = np.zeros(DIM)
    base_b[RANK : 2 * RANK] = 1.0
    emb = np.concatenate([base + 0.05 * rng.normal(size=(n_half, DIM)) for base in (base_a, base_b)])
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    ref, port = _pair(emb)
    q = np.stack([base_a, base_b, base_a + 0.1, base_b + 0.1]).astype(np.float32)
    assert check_search(ref, port, q / np.linalg.norm(q, axis=1, keepdims=True), 100, candidates=512) == (1, 0)


def test_share_counts_real_queries_not_pad_copies():
    """A query padded to 8 rows with share=1 keeps its whole budget: the
    same ids and certificate as alone, in both packages; m = 64 of 256
    blocks (25% coverage)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, k, m = 32_768, 50, 64
    both_rows = concentrated(rng, n + 1)
    ref, port = _pair(both_rows[:n])
    q1 = both_rows[n:]
    q8 = np.repeat(q1, 8, axis=0)
    out = {}
    for name, ix, call in (
        ("ref", ref, lambda ix, q, share: jts.twostage_topk_block(
            *_ref_args(ix), jnp.asarray(q), k, m, ix._snapshot()[2], ix._snapshot()[3], ix._sketch.ub_slack, share)),
        ("port", port, lambda ix, q, share: twostage.twostage_topk_block(
            *_port_args(ix), torch.from_numpy(q), k, m, ix._snapshot()[2], ix._snapshot()[3], ix._sketch.ub_slack, share)),
    ):
        v1, i1, c1 = (np.asarray(a) for a in call(ix, q1, 0))
        v8, i8, c8 = (np.asarray(a) for a in call(ix, q8, 1))
        np.testing.assert_array_equal(i8[:1], i1)
        np.testing.assert_array_equal(i8[1:], np.repeat(i8[:1], 7, axis=0))
        np.testing.assert_allclose(v8[:1], v1, atol=1e-6)
        assert bool(c1[0]) and bool(c8[0])
        out[name] = i1
    np.testing.assert_array_equal(out["port"], out["ref"])


def _ref_args(ix):
    sk = ix._sketch
    return ix._snapshot()[0], sk.sketches, sk.resid, sk.basis, np.int32(ix._size)


def _port_args(ix):
    sk = ix._sketch
    return ix._snapshot()[0], sk.sketches, sk.resid, sk.basis, ix._size


def test_per_slab_quotas_multi_slab_batched():
    rng = np.random.default_rng(5)
    n = 16_384
    rows = concentrated(rng, n + 4)
    ref, port = _pair(rows[:n], slab_rows=4_096)
    assert len(port._emb_slabs) >= 2 and len(port._emb_slabs) == len(ref._emb_slabs)
    assert check_search(ref, port, rows[n:], 20, candidates=96) == (1, 0)


def test_row_candidate_switch_selects_twostage_topk(conc, monkeypatch):
    """ISX_TWOSTAGE_ROWS=1: both packages take the row-candidate selection."""
    ref, port, _, rng = conc
    calls = []
    real = twostage.twostage_topk
    monkeypatch.setattr(twostage, "twostage_topk", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv("ISX_TWOSTAGE_ROWS", "1")
    assert check_search(ref, port, concentrated(rng, 4), 100, candidates=512) == (1, 0)
    assert calls == [1]


# -- bf16 sketches -----------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_bf16_sketch_certified_exact(quantize):
    rng = np.random.default_rng(6)
    ref, port = _pair(concentrated(rng, 20_000), quantize, sketch="bfloat16")
    assert port._sketch.sketches[0].dtype == torch.bfloat16
    assert float(port._sketch.ub_slack) > 0.0
    assert check_search(ref, port, concentrated(rng, 4), 100, candidates=512) == (1, 0)
    port.build_sketch()
    assert float(port._sketch.ub_slack) == 0.0


def _bounds_and_exact(port, q):
    """The port's stage-1 bounds and the full scan's exact scores of every
    row of the one-slab int8 index ``port`` for raw queries q."""
    sk = port._sketch
    slabs, _, scales, _ = port._snapshot()
    qt, qi, qs = twostage._exact_query_vector(torch.from_numpy(q), True)
    q_s, q_res, infl = twostage._query_bound_terms(qt, sk.basis, sk.ub_slack)
    ub = twostage._upper_bounds(q_s, q_res, infl, sk.sketches[0], sk.resid[0], None, 0, port._size)
    exact = scores_int8_reference(slabs[0], qi, qs, scales[0], port._size)
    return ub[:, : port._size], exact[:, : port._size]


def test_bf16_sketch_bound_holds_on_every_row():
    """UB >= the exact score on every row, on a flat corpus (no helpful
    spectrum), with queries equal to rows among them."""
    rng = np.random.default_rng(7)
    emb = flat(rng, 4_096)
    _, port = _pair(emb, "int8", sketch="bfloat16")
    ub, exact = _bounds_and_exact(port, np.concatenate([flat(rng, 4), emb[:4]]))
    assert bool((ub >= exact).all())


def test_bf16_bound_survives_rounding_midpoints():
    """Every sketch component just below a bf16 rounding midpoint, so each
    rounds down by ~2^-8 relative: the raw bf16 dot undershoots the exact
    score by ~2^-7, and the inflation must cover it; the same construction
    through the reference gives the same bound."""
    import jax.numpy as jnp

    d_s = 64
    basis = np.zeros((DIM, d_s), np.float32)
    basis[:d_s, :d_s] = np.eye(d_s, dtype=np.float32)
    t = 0.125 + 2.0**-11 - 2.0**-18
    u = np.full(d_s, t, np.float32)
    u[-1] = np.sqrt(1.0 - 63 * t * t)
    row = np.zeros((1, DIM), np.float32)
    row[0, :d_s] = u
    s16, resid, slack = twostage._sketch_chunk(torch.from_numpy(row), None, torch.from_numpy(basis), True)
    q = torch.from_numpy(row)
    q_s, q_res, infl = twostage._query_bound_terms(q, torch.from_numpy(basis), slack)
    ub = twostage._upper_bounds(q_s, q_res, infl, s16, resid, None, 0, 1)
    exact = float(q[0] @ q[0])
    raw = float(q_s.to(torch.bfloat16).float()[0] @ s16.float()[0])
    assert raw < exact - 0.005 and float(ub[0, 0]) >= exact
    r16, rres, rslack = jts._sketch_chunk(jnp.asarray(row), None, jnp.asarray(basis), True)
    np.testing.assert_array_equal(s16.float().numpy(), np.asarray(r16, np.float32))
    assert float(slack) == pytest.approx(float(rslack), rel=1e-6)


# -- fallbacks and the adaptive disable ---------------------------------------------------


@pytest.fixture
def flat_pair():
    rng = np.random.default_rng(8)
    ref, port = _pair(flat(rng, 8_000))
    return ref, port, rng


def test_fallback_on_flat_corpus_is_the_full_scan(flat_pair):
    ref, port, rng = flat_pair
    assert check_search(ref, port, flat(rng, 2), 20, candidates=8) == (0, 1)
    sels = [["p1"], []]
    ws, wi, got, delta = both(ref, port, "search_twostage_feedback_batch", flat(rng, 2), sels, 20, candidates=8)
    assert delta == (0, 1)
    assert_like_reference(got, ws, wi)


def test_adaptive_disable_and_rearm(flat_pair):
    ref, port, rng = flat_pair
    q = flat(rng, 2)
    for _ in range(VectorIndex.TWOSTAGE_DISABLE_AFTER):
        assert check_search(ref, port, q, 20, candidates=8) == (0, 1)
    assert port._sketch is None and ref._sketch is None
    assert check_search(ref, port, q, 20) == (0, 1)  # no bound pass at all
    for ix in (ref, port):
        ix.build_sketch()
        assert ix.sketch_fresh and ix._twostage_consec_failures == 0


def test_uncounted_failures_leave_the_disable_count(flat_pair):
    """count_failures=False (zero queries fail by construction): counted as
    fallbacks, neither advancing nor resetting the consecutive count."""
    ref, port, rng = flat_pair
    z = np.zeros((2, DIM), np.float32)
    for ix in (ref, port):
        ix._twostage_consec_failures = VectorIndex.TWOSTAGE_DISABLE_AFTER - 1
    assert check_search(ref, port, z, 20, candidates=8, count_failures=False) == (0, 1)
    _, _, _, delta = both(ref, port, "search_twostage_feedback_batch", z, [[]] * 2, 20, candidates=8,
                          count_failures=False)
    assert delta == (0, 1)
    assert port._twostage_consec_failures == VectorIndex.TWOSTAGE_DISABLE_AFTER - 1
    assert port.sketch_fresh
    check_search(ref, port, flat(rng, 2), 20, candidates=8)  # one counted failure disables
    assert port._sketch is None and ref._sketch is None


@pytest.mark.parametrize("rows_switch", [None, "1"], ids=["blocks", "rows"])
def test_tombstones_never_surface(rows_switch, monkeypatch):
    if rows_switch:
        monkeypatch.setenv("ISX_TWOSTAGE_ROWS", rows_switch)
    rng = np.random.default_rng(9)
    emb = concentrated(rng, 8_000)
    ref, port = _pair(emb, "int8", sketch=None)
    for ix in (ref, port):
        ix.remove_paths(["p7"])
        ix.build_sketch()
    assert check_search(ref, port, emb[7:8].copy(), 20, candidates=256) == (1, 0)
    assert 7 not in port.search_twostage(emb[7:8].copy(), 20, candidates=256)[1][0]


def test_empty_stale_and_missing_sketches_fall_back():
    rng = np.random.default_rng(10)
    ref, port = JaxIndex(DIM), VectorIndex(DIM, device="cpu")
    ws, wi, got, delta = both(ref, port, "search_twostage", np.zeros((1, DIM), np.float32), 5)
    assert got[0].shape == (1, 0) == ws.shape and delta == (0, 1)
    emb = flat(rng, 300)
    for ix in (ref, port):
        ix.add([f"p{i}" for i in range(300)], emb)
    assert check_search(ref, port, flat(rng, 1), 5) == (0, 1)  # no sketch
    for ix in (ref, port):
        ix.build_sketch()
        ix._sketch = ix._sketch._replace(built_rows=ix._size - 1)  # stale
    assert check_search(ref, port, flat(rng, 1), 5) == (0, 1)
    for ix in (ref, port):
        ix.build_sketch()
        ix.drop_sketch()
    assert check_search(ref, port, flat(rng, 1), 5) == (0, 1)


def test_k_covering_the_corpus_falls_back():
    """size == capacity and k >= size: c = capacity - 1 < k candidates."""
    rng = np.random.default_rng(11)
    ref, port = _pair(concentrated(rng, 4_096), min_capacity=4_096)
    assert port.capacity == 4_096
    assert check_search(ref, port, concentrated(rng, 1), 10_000) == (0, 1)


# -- ties ---------------------------------------------------------------------------------


@pytest.mark.parametrize("k", [37, 200])
def test_ties_return_the_reference_two_stage_order(k):
    """Byte-identical rows (exact integers, so every score is exact in both
    packages) at shuffled positions: the two-stage ids are the reference's,
    index for index, and scores bitwise, single and batched, plain and with
    feedback. The gathered rows follow the block selection, so this order is
    not the full scan's."""
    rng = np.random.default_rng(30 + k)
    _, rows = exact_rows(rng, 300, 64)
    emb = np.repeat(rows, 4, axis=0)[rng.permutation(1_200)]
    ref, port = _pair(emb, "int8")
    q = int_queries(rng, 3, 64)
    reordered = False
    for qq in (q[:1], q):
        ws, wi, got, delta = both(ref, port, "search_twostage", qq, k)
        assert delta == (1, 0)
        np.testing.assert_array_equal(got[0], ws)
        np.testing.assert_array_equal(got[1], wi)
        assert (np.diff(got[0], axis=1) == 0).any()  # the ties are there
        reordered |= not np.array_equal(got[1], port.search(qq, k)[1])
    assert reordered
    sels = [["p0"], [], ["p3", "p9"]]
    ws, wi, got, delta = both(ref, port, "search_twostage_feedback_batch", q, sels, k)
    assert delta == (1, 0)
    np.testing.assert_array_equal(got[1], wi)


def test_int8_rescore_is_kernel_b2_on_the_gathered_rows():
    """The block path's int8 rescore is the full scan's arithmetic: its
    scores of the chosen rows equal B2's plain version on the whole slab."""
    rng = np.random.default_rng(12)
    rows = concentrated(rng, 8_194)
    _, port = _pair(rows[:8_192], "int8")
    q = rows[8_192:]
    s, i = port.search_twostage(q, 50, candidates=64)
    slabs, _, scales, _ = port._snapshot()
    qi, qs = quantize_queries_int8(torch.from_numpy(q))
    full = scores_int8_reference(slabs[0], qi, qs, scales[0], port._size).numpy()
    np.testing.assert_array_equal(s, np.take_along_axis(full, i.astype(np.int64), axis=1))
    assert port.twostage_certified == 1


def test_certifiable_estimate_when_k_covers_the_corpus():
    """The build-time estimate agrees with the reference's on flat and
    concentrated samples. Where k covers the corpus the reference's sample
    rank k_s exceeds the sample: numpy raises (64 photos at the default
    k = 1000, which fails the reference's /scan with --search-twostage) or
    wraps the negative rank; the port answers 1.0, since the search then
    rescores every row."""
    rng = np.random.default_rng(13)
    kw = dict(k=1000, candidate_rows=twostage.DEFAULT_BLOCKS * twostage.BLOCK, fs_slack=0.0)
    for rows in (flat(rng, 2_048), concentrated(rng, 2_048)):
        basis = twostage.fit_basis(rows, 64)
        got = twostage.estimate_certifiable_fraction(rows, basis, corpus_size=10_000_000, **kw)
        assert got == pytest.approx(jts.estimate_certifiable_fraction(rows, basis, corpus_size=10_000_000, **kw),
                                    abs=1e-9)
    rows = flat(rng, 64)
    basis = twostage.fit_basis(rows, 64)
    assert twostage.estimate_certifiable_fraction(rows, basis, corpus_size=64, **kw) == 1.0
    with pytest.raises(ValueError):
        jts.estimate_certifiable_fraction(rows, basis, corpus_size=64, **kw)
    rows = concentrated(rng, 500)
    assert twostage.estimate_certifiable_fraction(rows, twostage.fit_basis(rows, 64), corpus_size=500, **kw) == 1.0


# ---- the bound's slack at the ladder's row widths -------------------------------


@pytest.mark.parametrize("dim", [256, 768, 1024, 1280])
def test_slack_follows_the_row_width(dim):
    """The UB inflation covers the D-long f32 reductions in the bound
    (gamma_D ~ D * 2^-23, the account the reference sizes its 1e-4 by at
    768): the reference's constant up to 768, so narrower answers stay the
    JAX package's, and 1e-4 * D / 768 above (ViT-H/14's 1024, bigG's 1280);
    the bound terms the search builds carry it."""
    want = jts.SLACK * max(dim, 768) / 768
    assert twostage.slack_for_dim(dim) == want
    assert twostage.slack_for_dim(dim) >= dim * 2.0**-23
    if dim <= 768:
        assert twostage.slack_for_dim(dim) == jts.SLACK == 1e-4
    basis = torch.from_numpy(np.linalg.qr(np.random.default_rng(dim).normal(size=(dim, 8)))[0].astype(np.float32))
    q = torch.zeros(2, dim)
    q[:, 0] = 1.0
    _, _, infl = twostage._query_bound_terms(q, basis, 0.0)
    assert torch.equal(infl, torch.full((2,), want, dtype=torch.float32))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_certified_answer_at_d1280_is_the_full_scan(quantize):
    """bigG's row width: ``search_twostage`` certifies queries drawn from the
    corpus's own mix and answers as the full scan (int8 bitwise, f32 within
    the full scan's own rounding)."""
    rng = np.random.default_rng(1280)
    x = concentrated(rng, 8192 + 4, dim=1280)
    port = VectorIndex(1280, device="cpu", quantize=quantize)
    port.add([f"p{i}" for i in range(8192)], x[:8192])
    port.build_sketch()
    assert port.sketch_fresh
    before = _counts(port)
    got = port.search_twostage(x[8192:], 20, candidates=512)
    assert tuple(a - b for a, b in zip(_counts(port), before)) == (1, 0)
    assert_same(got, port.search(x[8192:], 20), bitwise=quantize == "int8")
