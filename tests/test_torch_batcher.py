"""The search batcher (``--batch-window-ms``) and the serving warm-up of the
port's server, against the JAX package's engine on the same photos: they
mirror tests/test_robustness.py's batcher and warm-up tests.

Batched answers must equal the same queries served alone bitwise (each
query's text embedding from the text cache, as the reference's test has
it: only the batching of the index pass differs), and the reference's
answers up to 1e-5 in score with the same photos in the same order. The
batcher's own rules -- at most ``max_batch`` a batch, an error for every
request still queued at shutdown, a failed batch answered per request --
are held on a stand-in engine.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_tpu.config import tiny_test_config
from image_search_tpu.models import init_params as jax_init_params
from image_search_tpu.models.convert import save_checkpoint
from image_search_tpu.server import engine as ref_engine_mod
from image_search_tpu.server.args import ServerArgs as RefArgs
from image_search_tpu.server.engine import SearchEngine as RefEngine
from image_search_tpu.utils.metrics import global_metrics as ref_metrics
from image_search_tpu_torch.server.app import SearchBatcher, make_server
from image_search_tpu_torch.server.engine import SearchEngine, ServerArgs
from image_search_tpu_torch.utils.metrics import global_metrics


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


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both engines with int8 rows (their scores are exact integers times the
    scales, so a query scores alike at any batch size; an f32 GEMM may round
    a row differently at another B) over 6 photos whose short side is the
    tiny model's input (the resample is the identity in both packages); not
    scanned yet."""
    root = tmp_path_factory.mktemp("torch_batcher")
    media = str(root / "pics")
    os.makedirs(media)
    rng = np.random.default_rng(2)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (28, 28 + 5 * i, 3), dtype=np.uint8)).save(f"{media}/{i}.png")
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(8), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, k=4, index_quantize="int8")
    with pytest.MonkeyPatch.context() as mp:  # one device: the port's path
        mp.setattr(ref_engine_mod, "make_mesh", lambda *a, **kw: None)
        ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    return ref, port


def _gauge(metrics, name):
    return metrics.snapshot()["gauges"].get(name)


def test_warm_serving_buckets_matches_reference(engines):
    """An empty index warms nothing but sets the gauge; after a scan the
    buckets 8, 16 and 32 are run; no text-cache entry is left behind; an
    all-plain search_many then ranks as the direct path."""
    ref, port = engines
    for metrics in (ref_metrics, global_metrics):
        metrics.gauge("serving_warmup_done", 0.0)
    assert ref.warm_serving_buckets(32) == port.warm_serving_buckets(32) == 0
    assert _gauge(ref_metrics, "serving_warmup_done") == _gauge(global_metrics, "serving_warmup_done") == 1.0
    assert ref.scan().embedded == port.scan().embedded == 6
    for metrics in (ref_metrics, global_metrics):
        metrics.gauge("serving_warmup_done", 0.0)
    cached = dict(port._text_cache)
    assert ref.warm_serving_buckets(32) == port.warm_serving_buckets(32) == 3
    assert port.warm_serving_buckets(8) == 1
    assert _gauge(ref_metrics, "serving_warmup_done") == _gauge(global_metrics, "serving_warmup_done") == 1.0
    assert port._text_cache == cached
    queries = [f"warm check {i}" for i in range(3)]
    direct = [[r["image_path"] for r in port.search(q)] for q in queries]
    assert [[r["image_path"] for r in res] for res in port.search_many(queries)] == direct
    assert direct == [[r["image_path"] for r in ref.search(q)] for q in queries]


def test_batched_answers_equal_unbatched_bitwise(engines):
    """search_many of plain and feedback searches together: each answer is
    the same query's answer alone, bit for bit."""
    ref, port = engines
    if not len(port.index):
        port.scan()
    marked = [r["image_path"] for r in port.search("marks")[:2]]
    queries = [f"coalesced {i}" for i in range(11)]
    sels = [marked if i % 3 == 0 else [] for i in range(11)]
    alone = [port.search(q, s) for q, s in zip(queries, sels)]  # fills the text cache
    assert port.search_many(queries, sels) == alone
    assert port.search_many(queries[::-1], sels[::-1]) == alone[::-1]


def _post(base, body):
    req = urllib.request.Request(base + "/search", data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, None


def _concurrently(fn, args):
    out = [None] * len(args)
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(args[i]))) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_search_batcher_coalesces(engines):
    """Concurrent /search requests through the port's batcher (window 25
    ms): every answer equals the direct engine path bitwise and the
    reference's direct path; multi-query batches form, feedback ones too."""
    ref, port = engines
    if not len(port.index):
        port.scan()
    if not len(ref.index):
        ref.scan()
    queries = [f"query number {i}" for i in range(8)]
    direct = {q: port.search(q) for q in queries}
    marked = [direct[queries[0]][0]["image_path"]]
    direct_fb = port.search(queries[0], marked)
    for q in queries:
        want = ref.search(q)
        assert [d["image_path"] for d in direct[q]] == [d["image_path"] for d in want]
        np.testing.assert_allclose([d["score"] for d in direct[q]], [d["score"] for d in want], atol=1e-5, rtol=0)
    assert [d["image_path"] for d in direct_fb] == [d["image_path"] for d in ref.search(queries[0], marked)]
    before = global_metrics.snapshot()["counters"]
    server = make_server(port, batch_window_ms=25.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        got = _concurrently(lambda q: _post(base, {"q": q}), queries)
        for q, (status, body) in zip(queries, got):
            assert status == 200 and body["images"] == direct[q], q
        got = _concurrently(lambda _: _post(base, {"q": queries[0], "referenced_images": marked}), range(6))
        for status, body in got:
            assert status == 200 and body["images"] == direct_fb
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    after = global_metrics.snapshot()["counters"]
    # only real coalescing (batches of more than one) counts
    assert after.get("batched_searches", 0) - before.get("batched_searches", 0) >= 2
    assert after.get("batched_feedback_searches", 0) - before.get("batched_feedback_searches", 0) >= 2
    assert server.batcher._thread is not None and not server.batcher._thread.is_alive()


class _StandIn:
    """An engine whose search_many records its batches, optionally waits for
    ``release`` and optionally fails."""

    def __init__(self, fail=False):
        self.batches, self.fail = [], fail
        self.release, self.entered = threading.Event(), threading.Event()

    def search_many(self, queries, selections):
        self.batches.append(list(queries))
        self.entered.set()
        assert self.release.wait(timeout=60)
        if self.fail:
            raise RuntimeError("device lost")
        return [[{"q": q, "sel": list(s)}] for q, s in zip(queries, selections)]


def _submit_all(batcher, items):
    out = [None] * len(items)

    def one(i):
        try:
            out[i] = ("ok", batcher.submit(*items[i]))
        except Exception as err:  # the request's answer
            out[i] = ("error", str(err))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
    return threads, out


def test_batches_hold_at_most_max_batch_and_answer_in_order():
    eng = _StandIn()
    eng.release.set()
    b = SearchBatcher(eng, window_ms=300, max_batch=32)
    b.start()
    try:
        threads, out = _submit_all(b, [(f"q{i}", ("media/a.jpg",) if i % 2 else ()) for i in range(40)])
        for t in threads:
            t.join(timeout=60)
    finally:
        b.stop()
    assert max(len(x) for x in eng.batches) == 32 and sum(len(x) for x in eng.batches) == 40
    for i, (kind, res) in enumerate(out):
        assert kind == "ok" and res == [{"q": f"q{i}", "sel": ["media/a.jpg"] if i % 2 else []}]


def test_stop_answers_queued_requests_with_an_error():
    """A request queued at shutdown is answered with an error at once, the
    batch already running is answered when it ends, and a request after
    shutdown is refused: no handler waits forever."""
    eng = _StandIn()
    b = SearchBatcher(eng, window_ms=1)
    b.start()
    first, first_out = _submit_all(b, [("running", ())])
    assert eng.entered.wait(timeout=30)
    queued, out = _submit_all(b, [(f"queued {i}", ()) for i in range(3)])
    time.sleep(0.2)
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    for t in queued:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(o == ("error", "search batcher stopped") for o in out)
    eng.release.set()
    first[0].join(timeout=30)
    stopper.join(timeout=30)
    assert first_out[0] == ("ok", [{"q": "running", "sel": []}]) and not stopper.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit("late")


def test_a_failed_batch_fails_each_request():
    eng = _StandIn(fail=True)
    eng.release.set()
    b = SearchBatcher(eng, window_ms=50)
    b.start()
    try:
        threads, out = _submit_all(b, [(f"q{i}", ()) for i in range(5)])
        for t in threads:
            t.join(timeout=30)
    finally:
        b.stop()
    assert out == [("error", "device lost")] * 5
