"""The port's HTTP server against the reference's SearchEngine.

One tiny checkpoint (written by the reference's ``save_checkpoint``) and one
tiny PIL-written PNG corpus feed both; /scan must embed the same photos and
/search must return the same photos in the same order with scores within
1e-5, with and without ``referenced_images``. The photos' short side is the
tiny model's 28 px input, so the resample is the identity and exact in both
packages (test_torch_preprocess.py), and what is compared is the rest of the
path: decode, towers, index, Rocchio feedback, ranking and the wire format.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_search_tpu.config import tiny_test_config
from image_search_tpu.models import init_params as jax_init_params
from image_search_tpu.models.convert import save_checkpoint
from image_search_tpu.server.args import ServerArgs as RefArgs
from image_search_tpu.server import engine as ref_engine_mod
from image_search_tpu.server.engine import SearchEngine as RefEngine
from image_search_tpu.utils.metrics import global_metrics as ref_metrics
from image_search_tpu_torch.ingest.decode import DecodePool, decode_image, read_bmp24, write_bmp24
from image_search_tpu_torch.server.app import make_server, parse_args
from image_search_tpu_torch.server.engine import SearchEngine, ServerArgs, unsupported_flags
from image_search_tpu_torch.utils.metrics import global_metrics

SIZES = [(28, 28), (28, 45), (60, 28), (28, 33), (28, 28), (90, 28), (28, 70), (41, 28)]
CLIENT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "image_search_tpu_torch", "client", "static")


def _client_file(name):
    """The port's copy of the reference's client file (tests/test_torch_import.py
    holds it equal to the original)."""
    with open(os.path.join(CLIENT, name), "rb") as f:
        return f.read()


def _corpus(media):
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(media, "sub dir"), exist_ok=True)
    for i, (h, w) in enumerate(SIZES):
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        folder = os.path.join(media, "sub dir") if i % 3 == 0 else media
        Image.fromarray(arr).save(os.path.join(folder, f"photo_{i}.png"))
    with open(os.path.join(media, "broken.png"), "wb") as f:
        f.write(b"not a png")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_srv")
    media = str(root / "pics")
    _corpus(media)
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(3), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, chunk_size=3, k=50)
    ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    server = make_server(port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield ref, port, f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(method, url, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.fixture(scope="module")
def scanned(servers):
    ref, port, base = servers
    ref_stats = ref.scan()
    status, body = _request("GET", base + "/scan")
    assert status == 200
    return ref_stats, json.loads(body)


def test_scan_embeds_the_same_photos(servers, scanned):
    ref, port, _ = servers
    ref_stats, stats = scanned
    assert stats["embedded"] == ref_stats.embedded == len(SIZES)
    assert stats["decode_failures"] == ref_stats.decode_failures == 1
    assert stats["found"] == ref_stats.found == len(SIZES) + 1
    assert sorted(port.index.paths) == sorted(ref.index.paths)
    np.testing.assert_allclose(
        port.index.get_raw_embeddings(ref.index.paths), ref.index.get_raw_embeddings(ref.index.paths),
        atol=1e-5,
    )


@pytest.mark.parametrize("query", ["a dark square", "red", ""])
@pytest.mark.parametrize("n_marked", [0, 1, 2])
def test_search_matches_reference(servers, scanned, query, n_marked):
    ref, port, base = servers
    ref_plain = ref.search(query)
    marked = [d["image_path"] for d in ref_plain[1 : 1 + n_marked]]
    want = ref.search(query, marked)
    status, body = _request("POST", base + "/search", {"q": query, "referenced_images": marked})
    assert status == 200
    got = json.loads(body)["images"]
    assert [d["image_path"] for d in got] == [d["image_path"] for d in want]
    assert [d["id"] for d in got] == [d["id"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-5, rtol=0)
    # the body is exactly what the renderer makes of those rows
    assert body == port.render_images_json(got)


def test_render_is_byte_identical_to_reference(servers, scanned):
    ref, port, _ = servers
    rows = ref.search("anything", [])
    rows.append({"id": urllib.parse.quote('media/é "x".png', safe=""), "image_path": 'media/é "x".png', "score": 0.1})
    assert port.render_images_json(rows) == ref.render_images_json(rows)
    assert json.loads(port.render_images_json(rows)) == {"images": rows}


def test_urlencoded_id_resolves_as_selection(servers, scanned):
    ref, port, base = servers
    plain = ref.search("q", [])
    by_path = [plain[0]["image_path"]]
    by_id = [plain[0]["id"]]
    a = _request("POST", base + "/search", {"q": "q", "referenced_images": by_path})[1]
    b = _request("POST", base + "/search", {"q": "q", "referenced_images": by_id})[1]
    assert a == b


def test_health_media_and_errors(servers, scanned):
    _, port, base = servers
    status, body = _request("GET", base + "/health")
    assert status == 200 and json.loads(body) == {"status": "ok", "model": "clip-tiny-test", "corpus": len(SIZES)}
    path = port.search("x")[0]["image_path"]
    status, data = _request("GET", base + "/" + urllib.parse.quote(path))
    assert status == 200 and data[:4] == b"\x89PNG"
    assert _request("GET", base + "/media/../tiny.safetensors")[0] == 404
    assert _request("GET", base + "/media/missing.png")[0] == 404
    assert _request("POST", base + "/search", raw=b"{not json")[0] == 400
    assert _request("POST", base + "/search", {"q": 3})[0] == 400
    # a GET no route claims is a client route: the web client's index.html
    assert _request("GET", base + "/nope") == (200, _client_file("index.html"))


def test_rescan_is_idempotent(servers, scanned):
    _, _, base = servers
    status, body = _request("GET", base + "/scan")
    stats = json.loads(body)
    assert status == 200 and stats["embedded"] == 0 and stats["skipped_existing"] == len(SIZES)


@pytest.mark.parametrize(
    "flags",
    [
        ["--search-approx"],
        ["--mesh-data", "2"],
        ["--mesh-model", "2"],
        ["--index-quantize", "bfloat16"],
        ["--batch-window-ms", "5"],
        ["--thumb-cache", "/tmp/thumbs"],
        ["--prune-on-scan"],
        ["--from-hf", "auto"],
        ["--profiler-port", "9999"],
    ],
)
def test_unported_flags_raise_at_startup(flags, tmp_path, monkeypatch, caplog):
    """Meshes and the profiler still raise at startup; the one-card flags are
    ported and parse to no refusal. ``--from-hf auto`` is ported: where the
    hub cannot be reached (here: ``transformers`` made unimportable, so no
    request is ever tried) the engine warns and starts on random weights."""
    args, device = parse_args(flags + ["--device", "cpu"])
    if flags[0] in ("--mesh-data", "--mesh-model", "--profiler-port"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            SearchEngine(args, device=device)
    elif flags[0] == "--from-hf":
        monkeypatch.setitem(sys.modules, "transformers", None)
        args, device = parse_args(flags + [
            "--device", "cpu", "--model", "clip-tiny-test", "--media-dir", str(tmp_path / "pics"),
            "--index-dir", str(tmp_path / "idx"), "--model-weights", str(tmp_path / "none.safetensors"),
        ])
        assert unsupported_flags(args) == []
        with caplog.at_level("WARNING", logger="image_search_tpu_torch.server.engine"):
            engine = SearchEngine(args, device=device)
        assert "--from-hf clip-tiny-test failed" in caplog.text and "RANDOM" in caplog.text
        assert engine.cfg.name == "clip-tiny-test" and not os.path.exists(tmp_path / "none.safetensors")
    else:
        assert unsupported_flags(args) == []


def test_parse_args_keeps_reference_flags():
    args, device = parse_args(["-m", "/photos", "--index-quantize", "int8", "--k", "7"])
    assert device == "cuda" and args.media_dir == "/photos"
    assert args.index_quantize == "int8" and args.k == 7 and isinstance(args, ServerArgs)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    args = ServerArgs(media_dir=str(tmp_path), index_dir=str(tmp_path / "i"), model="clip-tiny-test")
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine(args, device="cuda")


@pytest.mark.parametrize("h,w", [(5, 7), (16, 16), (3, 1), (31, 2)])
def test_bmp_reader_matches_pil(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    path = str(tmp_path / "x.bmp")
    write_bmp24(path, arr)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(read_bmp24(f.read()), arr)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), arr)
    # PIL's top-down and bottom-up BMPs read the same
    Image.fromarray(arr).save(str(tmp_path / "pil.bmp"))
    with open(str(tmp_path / "pil.bmp"), "rb") as f:
        np.testing.assert_array_equal(read_bmp24(f.read()), arr)


def test_bmp_reader_rejects_other_files():
    with pytest.raises(ValueError):
        read_bmp24(b"BM" + b"\0" * 10)
    with pytest.raises(ValueError):
        read_bmp24(b"\x89PNG" + b"\0" * 60)


def test_decode_pool_skips_failures(tmp_path):
    good = str(tmp_path / "a.bmp")
    write_bmp24(good, np.zeros((4, 6, 3), np.uint8))
    bad = str(tmp_path / "b.jpg")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    assert decode_image(bad) is None
    pool = DecodePool(workers=2)
    try:
        kept, images = pool.submit_batch([good, bad, str(tmp_path / "missing.png")]).result(timeout=60)
    finally:
        pool.close()
    assert kept == [good] and images[0].shape == (4, 6, 3)


@pytest.mark.parametrize("n_marked", [0, 2])
def test_search_image_without_twostage_matches_reference(servers, scanned, n_marked):
    """POST /search_image on the full-scan engines: the plain search, and
    with ?ref= the Rocchio feedback search on the image embedding."""
    ref, port, base = servers
    with open(sorted(p for p in port.index.paths if p.endswith("photo_1.png"))[0], "rb") as f:
        data = f.read()
    refs = [d["image_path"] for d in ref.search("q")[1 : 1 + n_marked]]
    want = ref.search_by_image(data, None, refs)
    qs = urllib.parse.urlencode([("ref", r) for r in refs])
    status, body = _request("POST", base + "/search_image" + ("?" + qs if qs else ""), raw=data)
    assert status == 200
    got = json.loads(body)["images"]
    assert [d["id"] for d in got] == [d["id"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-5, rtol=0)


# ---- GET /duplicates: these run last, on the corpus plus one duplicated photo ----


@pytest.fixture(scope="module")
def with_duplicate(servers, scanned):
    """A byte-identical copy of one photo, scanned into both engines."""
    ref, port, base = servers
    src = sorted(p for p in ref.index.paths if p.endswith(".png"))[0]
    with open(src, "rb") as f:
        data = f.read()
    with open(os.path.join(port.media_dir, "copy_of_photo.png"), "wb") as f:
        f.write(data)
    ref.scan()
    status, body = _request("GET", base + "/scan")
    assert status == 200 and json.loads(body)["embedded"] == 1
    return port.to_media_path(src), "media/copy_of_photo.png"


def _get_json(url):
    status, body = _request("GET", url)
    return status, json.loads(body) if body else None


@pytest.mark.parametrize("threshold", [0.99, 0.9])
def test_duplicates_matches_reference(servers, with_duplicate, threshold):
    ref, port, base = servers
    want = ref.find_duplicate_groups(threshold)
    status, body = _get_json(base + f"/duplicates?threshold={threshold}")
    assert status == 200 and set(body) == {"groups", "mode"}
    assert body["mode"] == ref.last_duplicate_mode == "legacy_exact"
    assert sorted(map(sorted, body["groups"])) == sorted(map(sorted, want))
    assert any(set(with_duplicate) <= set(g) for g in body["groups"])


def test_duplicates_async_job(servers, with_duplicate):
    ref, port, base = servers
    status, job = _get_json(base + "/duplicates?async=1&threshold=0.99")
    assert status == 202 and job["state"] == "running"
    assert job["poll"] == f"/duplicates?job={job['job']}"
    for _ in range(600):
        status, body = _get_json(base + job["poll"])
        if status != 202:
            break
        assert body["state"] == "running" and 0.0 <= body["progress"] <= 1.0
        time.sleep(0.05)
    assert status == 200 and body["state"] == "done" and body["job"] == job["job"]
    assert body["mode"] == "legacy_exact"
    want = ref.find_duplicate_groups(0.99)
    assert sorted(map(sorted, body["groups"])) == sorted(map(sorted, want))


def test_duplicates_errors(servers, with_duplicate, monkeypatch):
    _, port, base = servers
    for bad in ("0", "-0.5", "1.5", "abc", "nan"):
        assert _request("GET", base + f"/duplicates?threshold={bad}")[0] == 400
    assert _request("GET", base + "/duplicates?job=nope")[0] == 404
    # a running job: joined at its threshold, 409 at another
    release = threading.Event()
    real = port.find_duplicate_groups

    def slow(threshold=0.95, approx=None):
        assert release.wait(timeout=60)
        return real(threshold)

    monkeypatch.setattr(port, "find_duplicate_groups", slow)
    status, job = _get_json(base + "/duplicates?async=1&threshold=0.9")
    assert status == 202
    status, body = _get_json(base + "/duplicates?async=true&threshold=0.8")
    assert status == 409 and body["job"] == job["job"] and body["threshold"] == 0.9
    status, body = _get_json(base + "/duplicates?async=1&threshold=0.9")
    assert status == 202 and body["job"] == job["job"] and body["state"] == "running"
    assert _get_json(base + job["poll"])[0] == 202
    release.set()
    for _ in range(600):
        status, body = _get_json(base + job["poll"])
        if status != 202:
            break
        time.sleep(0.05)
    assert status == 200 and body["groups"]
    # a failed job answers 500
    monkeypatch.setattr(port, "find_duplicate_groups", lambda threshold=0.95, approx=None: 1 / 0)
    status, job = _get_json(base + "/duplicates?async=1")
    for _ in range(600):
        status, body = _get_json(base + job["poll"])
        if status != 202:
            break
        time.sleep(0.05)
    assert status == 500 and body == {"job": job["job"], "state": "failed"}
    assert _request("GET", base + "/duplicates")[0] == 500


# ---- POST /search on an index of duplicated photos: tied scores ----


@pytest.fixture(scope="module", params=[None, "int8"], ids=["f32", "int8"])
def tied_servers(request, tmp_path_factory):
    """Both engines over one index of 24 distinct rows stored 5 times each
    (duplicated photos), added directly: rows with four entries of +-1/2, so
    the stored rows are exact and every copy scores exactly like the others."""
    root = tmp_path_factory.mktemp("torch_tied")
    media = str(root / "pics")
    os.makedirs(media)
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(4), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, chunk_size=3, k=50, index_quantize=request.param)
    ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    rng = np.random.default_rng(12)
    rows = np.zeros((24, cfg.projection_dim), np.float32)
    for r in rows:
        r[rng.choice(cfg.projection_dim, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    emb = np.repeat(rows, 5, axis=0)[rng.permutation(120)]
    paths = [os.path.join(media, f"dup_{i:03d}.png") for i in range(120)]
    assert port.index.add(paths, emb) == ref.index.add(paths, emb) == 120
    server = make_server(port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield ref, port, f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("query", ["a dark square", "red", ""])
@pytest.mark.parametrize("n_marked", [0, 2])
def test_search_ties_return_reference_ids_in_order(tied_servers, query, n_marked):
    """Copies of a photo score alike: the port returns the reference's ids
    in the reference's order, the k = 50 boundary inside a group of copies."""
    ref, port, base = tied_servers
    marked = [d["image_path"] for d in ref.search(query)[:n_marked]]
    want = ref.search(query, marked)
    status, body = _request("POST", base + "/search", {"q": query, "referenced_images": marked})
    assert status == 200
    got = json.loads(body)["images"]
    assert [d["id"] for d in got] == [d["id"] for d in want]
    scores = [d["score"] for d in got]
    assert len(got) == 50 and len(set(scores)) < 50  # tied scores among the results


# ---- --search-twostage, POST /search_image and GET /metrics ----


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def twostage_servers(request, tmp_path_factory):
    """Both engines with --search-twostage --index-quantize int8 and the
    sketch dtype, over the photo corpus, scanned. The reference engine runs
    without a device mesh (the tests' 8 virtual CPU devices would give it
    one, and a meshed engine takes another path), as the port runs."""
    root = tmp_path_factory.mktemp("torch_twostage_srv")
    media = str(root / "pics")
    _corpus(media)
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(5), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, chunk_size=3, k=50, index_quantize="int8",
                  search_twostage=True, sketch_dtype=request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "make_mesh", lambda *a, **kw: None)
        ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    server = make_server(port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    ref.scan()
    assert json.loads(_request("GET", base + "/scan")[1])["embedded"] == len(SIZES)
    assert ref.index.sketch_fresh and port.index.sketch_fresh
    want = torch.bfloat16 if request.param == "bfloat16" else torch.float32
    assert port.index._sketch.sketches[0].dtype == want
    yield ref, port, base
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


def _same_images(got, want):
    assert [d["id"] for d in got] == [d["id"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-5, rtol=0)


def _same_twostage_counts(ref, port):
    assert (port.index.twostage_certified, port.index.twostage_fallbacks) == (
        ref.index.twostage_certified, ref.index.twostage_fallbacks)


@pytest.mark.parametrize("n_marked", [0, 2])
def test_twostage_search_matches_reference(twostage_servers, n_marked):
    """A cold /search takes the fused tokens -> tower -> Rocchio -> two-stage
    path in both engines (fused_searches moves, the text cache fills with
    the reference's embedding); the warm repeat takes the two-stage feedback
    batch and answers alike; the certified counts equal the reference's."""
    ref, port, base = twostage_servers
    marked = [d["image_path"] for d in ref.search(f"marks {n_marked}")[:n_marked]]
    port.search(f"marks {n_marked}")
    query = f"a dark square {n_marked}"
    fused = _counter(ref_metrics, "fused_searches"), _counter(global_metrics, "fused_searches")
    certified = port.index.twostage_certified
    want = ref.search(query, marked)
    status, body = _request("POST", base + "/search", {"q": query, "referenced_images": marked})
    assert status == 200
    got = json.loads(body)["images"]
    _same_images(got, want)
    assert len(got) == len(SIZES)
    assert _counter(ref_metrics, "fused_searches") == fused[0] + 1
    assert _counter(global_metrics, "fused_searches") == fused[1] + 1
    assert port.index.twostage_certified == certified + 1
    _same_twostage_counts(ref, port)
    np.testing.assert_allclose(port._cache_get(query).numpy(), np.asarray(ref._text_cache[query]), atol=1e-5)
    warm = _request("POST", base + "/search", {"q": query, "referenced_images": marked})[1]
    _same_images(json.loads(warm)["images"], ref.search(query, marked))
    assert _counter(global_metrics, "fused_searches") == fused[1] + 1  # warm: no second fused run
    assert port.index.twostage_certified == certified + 2
    _same_twostage_counts(ref, port)


def _photo_bytes(port):
    path = sorted(p for p in port.index.paths if p.endswith("photo_4.png"))[0]
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("variant", ["plain", "ref", "k"])
def test_search_image_matches_reference(twostage_servers, variant):
    """POST /search_image: the photo's bytes as the query, at B=1 through the
    vision tower, then the two-stage path (with ?ref=, its feedback batch)."""
    ref, port, base = twostage_servers
    data = _photo_bytes(port)
    k, refs = None, []
    if variant == "ref":
        refs = [d["image_path"] for d in ref.search("marks for images")[:2]]
        port.search("marks for images")
    if variant == "k":
        k = 3
    want = ref.search_by_image(data, k, refs)
    qs = urllib.parse.urlencode([("ref", r) for r in refs] + ([("k", k)] if k else []))
    status, body = _request("POST", base + "/search_image" + ("?" + qs if qs else ""), raw=data)
    assert status == 200
    got = json.loads(body)["images"]
    _same_images(got, want)
    assert len(got) == (k or len(SIZES))
    assert got[0]["image_path"].endswith("photo_4.png") or refs  # the photo finds itself
    _same_twostage_counts(ref, port)


def test_search_image_rejects_bad_requests(twostage_servers):
    ref, port, base = twostage_servers
    data = _photo_bytes(port)
    assert _request("POST", base + "/search_image", raw=b"")[0] == 400
    for bad in ("abc", "", "1.5"):
        assert _request("POST", base + "/search_image?k=" + bad, raw=data)[0] == 400
    status, body = _request("POST", base + "/search_image", raw=b"not an image")
    assert status == 400 and json.loads(body) == {"error": "could not decode query image"}
    with pytest.raises(ValueError, match="could not decode query image"):
        ref.search_by_image(b"not an image")


def test_metrics_keys_and_gauges(twostage_servers):
    """GET /metrics: the reference's keys; the two-stage gauges equal the
    reference engine's after the same requests; corpus_size and the model."""
    ref, port, base = twostage_servers
    ref.search("metrics probe")
    _request("POST", base + "/search", {"q": "metrics probe", "referenced_images": []})
    status, body = _request("GET", base + "/metrics")
    assert status == 200
    snap = json.loads(body)
    assert set(snap) == {"uptime_sec", "counters", "gauges", "latencies", "model"}
    assert snap["model"] == "clip-tiny-test"
    assert snap["gauges"]["corpus_size"] == float(len(SIZES))
    want = {k: v for k, v in ref_metrics.snapshot()["gauges"].items() if k.startswith("twostage_")}
    got = {k: v for k, v in snap["gauges"].items() if k.startswith("twostage_")}
    assert got == want and got["twostage_certified_total"] >= 1 and got["twostage_sketch_active"] == 1.0
    for name in ("searches", "fused_searches", "image_searches", "scans", "images_embedded"):
        assert snap["counters"][name] >= 1
    assert {"scan", "sketch_build", "index_search", "image_embed"} <= set(snap["latencies"])
    assert set(snap["latencies"]) <= set(ref_metrics.snapshot()["latencies"])


# ---- the web client: GET /, /static/<file> and the SPA fallback ----


def _get(url):
    req = urllib.request.Request(url, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def test_client_is_served_byte_identical(servers):
    """GET / and every client route answer the reference's index.html;
    /static/<file> the port's copies, byte-equal to the originals, with
    their content types; a missing static file is 404, not the client."""
    _, _, base = servers
    index = _client_file("index.html")
    for path in ("/", "/some/client/route", "/search", "/remove", "/static", "/media"):
        assert _get(base + path) == (200, "text/html", index), path
    for name, ctype in (("index.html", "text/html"), ("app.js", "text/javascript"),
                        ("logic.js", "text/javascript"), ("style.css", "text/css")):
        assert _get(base + "/static/" + name) == (200, ctype, _client_file(name))
    assert _get(base + "/static/missing.js")[0] == 404
    assert _request("GET", base + "/duplicates?job=unknown")[0] == 404
    assert _request("POST", base + "/nope", {"q": "x"})[0] == 405


@pytest.mark.parametrize("path", ["/static/../engine.py", "/static/%2e%2e/engine.py", "/static/..%2fapp.py",
                                  "/static//etc/passwd", "/static/%2fetc%2fpasswd", "/static/link/app.py",
                                  "/static/escape.txt"])
def test_static_refuses_paths_outside_its_directory(tmp_path, path):
    """A path that resolves outside --static-dir (``..``, an absolute path,
    a symlink) answers 404, as /media/../ does."""
    static = tmp_path / "static"
    static.mkdir()
    (static / "index.html").write_text("<html>client</html>")
    (tmp_path / "secret.txt").write_text("secret")
    os.symlink(os.path.dirname(os.path.abspath(__file__)), static / "link")
    os.symlink(tmp_path / "secret.txt", static / "escape.txt")
    engine = type("E", (), {"media_dir": str(tmp_path)})()
    server = make_server(engine, static_dir=str(static))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        status, _, body = _get(base + path)
        assert status == 404 and b"secret" not in body
        assert _get(base + "/static/index.html")[2] == b"<html>client</html>"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


# ---- POST /remove over HTTP, against the reference engine ----


@pytest.fixture(scope="module")
def remove_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_remove_srv")
    media = str(root / "pics")
    os.makedirs(media)
    rng = np.random.default_rng(13)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, size=(28, 28 + 3 * i, 3), dtype=np.uint8)).save(f"{media}/r_{i}.png")
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(9), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, k=50, index_quantize="int8")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "make_mesh", lambda *a, **kw: None)
        ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    ref.scan()
    server = make_server(port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    assert json.loads(_request("GET", base + "/scan")[1])["embedded"] == 5
    yield ref, port, base
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_remove_and_restore_over_http(remove_servers):
    """POST /remove -> {"removed": n}, then every search omits the photo and
    equals the reference engine's after the same removal; "restore": true ->
    {"restored": n} and a rescan brings it back. Bodies the reference
    refuses answer 400."""
    ref, port, base = remove_servers
    victim = ref.search("x")[0]["image_path"]
    status, body = _request("POST", base + "/remove", {"images": [victim, victim, "media/ghost.png"]})
    assert status == 200 and json.loads(body) == {"removed": ref.remove_images([victim, victim, "media/ghost.png"])} == {"removed": 1}
    for q, marked in (("x", []), ("y", [ref.search("y")[0]["image_path"]])):
        got = json.loads(_request("POST", base + "/search", {"q": q, "referenced_images": marked})[1])["images"]
        want = ref.search(q, marked)
        assert [d["id"] for d in got] == [d["id"] for d in want] and victim not in [d["image_path"] for d in got]
        np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], atol=1e-5, rtol=0)
    assert json.loads(_request("GET", base + "/scan")[1])["embedded"] == 0
    for bad in (b"not json", b"[]", b'{"nope": 1}', b'{"images": 3}', b'{"images": null}'):
        status, body = _request("POST", base + "/remove", raw=bad)
        assert status == 400 and json.loads(body) == {"error": 'expected {"images": [...]}'}
    status, body = _request("POST", base + "/remove", {"images": [victim], "restore": True})
    assert status == 200 and json.loads(body) == {"restored": ref.restore_images([victim])} == {"restored": 1}
    ref.scan()
    assert json.loads(_request("GET", base + "/scan")[1])["embedded"] == 1
    got = json.loads(_request("POST", base + "/search", {"q": "x", "referenced_images": []})[1])["images"]
    assert [d["id"] for d in got] == [d["id"] for d in ref.search("x")] and victim in [d["image_path"] for d in got]


# ---- --search-approx and --index-quantize bfloat16, served ----


@pytest.fixture(scope="module", params=[dict(search_approx=True, index_quantize="int8"),
                                        dict(index_quantize="bfloat16")], ids=["approx", "bf16"])
def flag_servers(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_flag_srv")
    media = str(root / "pics")
    _corpus(media)
    cfg = tiny_test_config()
    ckpt = str(root / "tiny.safetensors")
    save_checkpoint(ckpt, jax_init_params(jax.random.key(10), cfg), cfg)
    common = dict(model_weights=ckpt, media_dir=media, chunk_size=3, k=50, **request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "make_mesh", lambda *a, **kw: None)
        ref = RefEngine(RefArgs(index_dir=str(root / "ref_idx"), **common))
    port = SearchEngine(ServerArgs(index_dir=str(root / "port_idx"), **common), device="cpu")
    server = make_server(port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    ref.scan()
    assert json.loads(_request("GET", base + "/scan")[1])["embedded"] == len(SIZES)
    yield ref, port, base
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_flag_servers_match_reference(flag_servers):
    """/search plain and with feedback and /search_image under each flag:
    the reference's photos in its order, scores within 1e-5."""
    ref, port, base = flag_servers
    marked = [d["image_path"] for d in ref.search("marks")[:2]]
    for q, refs in (("a dark square", []), ("a dark square", marked)):
        status, body = _request("POST", base + "/search", {"q": q, "referenced_images": refs})
        assert status == 200
        _same_images(json.loads(body)["images"], ref.search(q, refs))
    data = _photo_bytes(port)
    status, body = _request("POST", base + "/search_image", raw=data)
    assert status == 200
    _same_images(json.loads(body)["images"], ref.search_by_image(data))
