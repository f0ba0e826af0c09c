"""HTTP server of the port, on the standard library's ``ThreadingHTTPServer``.

The reference's surface for the main path (``image_search_tpu/server/
app.py``), with byte-identical bodies for the same engine results:

- ``POST /search`` -- body ``{"q": str, "referenced_images": [str]}``,
  response ``{"images": [{"id", "image_path", "score"}]}``;
- ``GET /scan`` -- runs the ingest (one at a time) and answers when it is done;
- ``GET /duplicates[?threshold=0.95]`` -- near-duplicate photo groups,
  ``{"groups": [[...]], "mode": ...}``; with ``?async=1`` it answers 202 with
  a job id and a ``poll`` URL, and ``?job=<id>`` answers 202 with the
  progress while the scan runs and 200 with the groups when it is done. One
  scan runs at a time; an async request at another threshold while a job
  runs gets 409;
- ``POST /search_image[?k=N][&ref=media/...]`` -- raw image bytes as the
  query (``ref`` repeats, marked results for Rocchio feedback), the same
  response as ``/search``; 400 on an empty body, a bad ``k`` or bytes that
  do not decode;
- ``GET /metrics`` -- the counters, gauges and latencies of
  ``utils.metrics.global_metrics``, the ``corpus_size`` gauge and the model;
- ``POST /remove`` -- body ``{"images": ["media/...", ...]}``: the photos are
  tombstoned and excluded from rescans, ``{"removed": n}``; with
  ``"restore": true`` the exclusions are cleared instead, ``{"restored": n}``
  (the next scan re-embeds the files); 400 on another body;
- ``GET /health`` and ``GET /media/<path>`` (the photo directory);
- the web client: ``GET /`` answers ``index.html``, ``GET /static/<file>``
  the files of ``--static-dir`` (default: this package's copy of the
  client, ``client/static``), and any other GET that no route claims
  answers ``index.html`` too (the client's own routes). A path that
  resolves outside its directory answers 404.

With ``--batch-window-ms`` > 0, concurrent ``/search`` requests are collected
for that long after the first and answered by one ``engine.search_many``
(:class:`SearchBatcher`), and the serving shapes are warmed on a background
thread at startup and after every scan that embedded photos. Run it with the
reference's flags::

    python -m image_search_tpu_torch.server.app --media-dir ~/Pictures \\
        --index-dir ./index --index-quantize int8 [--device cuda]
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import queue
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from image_search_tpu_torch.server import args as server_args
from image_search_tpu_torch.server.engine import MEDIA_PREFIX, SearchEngine
from image_search_tpu_torch.server.wire import SearchParams
from image_search_tpu_torch.utils.metrics import global_metrics, span

log = logging.getLogger(__name__)

MAX_BODY = 16 * 1024 * 1024
CLIENT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "client", "static")


class SearchBatcher:
    """Coalesces concurrent searches, plain and feedback alike, into one
    ``engine.search_many``: one queue and one worker thread. The worker
    takes the first request, collects more for ``window_ms`` after it (at
    most ``max_batch`` in all) and answers the batch from one text-tower
    batch and one index pass; each request's ``referenced_images`` ride
    along as its own selection row, and an empty selection is the plain
    search bitwise. ``stop`` answers every request still queued with an
    error, so no handler waits forever. Each request's wait in the queue,
    from ``submit`` to the worker taking it, adds to the counters
    ``search_queue_wait_s`` and ``search_queue_waits``; collecting a batch
    is the span ``batcher.collect``."""

    def __init__(self, engine: SearchEngine, window_ms: float, max_batch: int = 32):
        self.engine = engine
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()  # orders submit's check-and-put against stop
        self._stopped = False
        self._thread = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="search-batcher", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Fail every queued request at once (a batch already running is
        answered when it ends), then end the worker."""
        with self._lock:
            self._stopped = True
        self._drain()
        self._queue.put(None)  # wakes the worker
        if self._thread is not None:
            self._thread.join(timeout)
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                _fail([item])

    def submit(self, query: str, referenced_images=()):
        """Blocks until the batch holding this request is answered -> its
        result list; raises if the batch failed or the batcher stopped."""
        fut: Future = Future()
        with self._lock:
            if self._stopped:
                raise RuntimeError("search batcher stopped")
            self._queue.put((query, tuple(referenced_images), fut, time.monotonic()))
        return fut.result()

    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            taken = time.monotonic()
            batch, stopping, waited = [first], False, taken - first[3]
            with span("batcher.collect"):
                deadline = taken + self.window
                while len(batch) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None:
                        stopping = True
                        break
                    waited += time.monotonic() - item[3]
                    batch.append(item)
            global_metrics.inc("search_queue_wait_s", waited)
            global_metrics.inc("search_queue_waits", len(batch))
            if stopping:
                _fail(batch)
                return
            try:
                results = self.engine.search_many([q for q, _, _, _ in batch], [sel for _, sel, _, _ in batch])
            except Exception as err:  # answered per request
                for _, _, fut, _ in batch:
                    fut.set_exception(err)
                continue
            for (_, _, fut, _), res in zip(batch, results):
                fut.set_result(res)


def _fail(batch) -> None:
    for _, _, fut, _ in batch:
        if not fut.done():
            fut.set_exception(RuntimeError("search batcher stopped"))


def _spawn_warmup(engine: SearchEngine, batcher) -> None:
    """Warm the serving shapes on a background thread (with the batcher
    only, as the reference does); requests arriving meanwhile share the
    card as usual."""
    if batcher is None:
        return

    def warm():
        try:
            engine.warm_serving_buckets(batcher.max_batch)
        except Exception:
            log.exception("serving warmup failed (non-fatal)")

    threading.Thread(target=warm, name="serving-warmup", daemon=True).start()


class _DupJob:
    """One asynchronous duplicate scan, run on its own thread."""

    def __init__(self, threshold: float):
        self.id = uuid.uuid4().hex[:12]
        self.threshold = threshold
        self.done = threading.Event()
        self.groups = None
        self.mode = None
        self.failed = False


def _dup_progress() -> float:
    return global_metrics.snapshot()["gauges"].get("duplicate_scan_progress", 0.0)


def _handler_class(engine: SearchEngine, scan_lock: threading.Lock, static_dir: str, batcher):
    dup_lock = threading.Lock()  # single-flight: one duplicate scan at a time
    jobs_lock = threading.Lock()  # guards `jobs` (check-then-start of a job)
    jobs: dict = {}  # "last": the running or last finished async job

    def run_job(job: _DupJob) -> None:
        try:
            with dup_lock:
                job.groups = engine.find_duplicate_groups(job.threshold)
                job.mode = engine.last_duplicate_mode
        except Exception:  # reported to the poller as a failed job
            log.exception("duplicate scan job failed")
            job.failed = True
        finally:
            job.done.set()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access logs to logging
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body: bytes, ctype: str = "application/json"):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, obj) -> None:
            self._send(status, json.dumps(obj).encode())

        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            path = url.path
            if path == "/scan":
                return self._scan()
            if path == "/duplicates":
                query = urllib.parse.parse_qs(url.query, keep_blank_values=True)
                return self._duplicates({k: v[0] for k, v in query.items()})
            if path == "/metrics":
                snap = global_metrics.snapshot()
                snap["gauges"]["corpus_size"] = float(len(engine.index))
                snap["model"] = engine.cfg.name
                return self._json(200, snap)
            if path == "/health":
                return self._json(
                    200, {"status": "ok", "model": engine.cfg.name, "corpus": len(engine.index)}
                )
            if path.startswith("/" + MEDIA_PREFIX):
                return self._media(urllib.parse.unquote(path[1:]))
            if path.startswith("/static/"):
                return self._static(urllib.parse.unquote(path[len("/static/"):]))
            # "/" and the client's own routes (the SPA fallback)
            self._file(os.path.join(static_dir, "index.html"))

        def do_POST(self):
            url = urllib.parse.urlsplit(self.path)
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY:
                return self._json(413, {"error": "body too large"})
            body = self.rfile.read(n)
            if url.path == "/search_image":
                return self._search_image(body, urllib.parse.parse_qs(url.query, keep_blank_values=True))
            if url.path == "/remove":
                return self._remove(body)
            if url.path != "/search":
                return self._json(405, {"error": "method not allowed"})
            try:
                params = SearchParams.from_json(json.loads(body))
            except Exception:
                return self._json(400, {"error": "invalid SearchParams"})
            try:
                if batcher is not None:
                    images = batcher.submit(params.q, params.referenced_images)
                else:
                    images = engine.search(params.q, params.referenced_images)
            except Exception:
                log.exception("search failed")
                return self._send(500, b"")
            with span("http.render"):
                self._send(200, engine.render_images_json(images))

        def _search_image(self, body: bytes, query: dict):
            if not body:
                return self._json(400, {"error": "empty body"})
            try:
                k = int(query.get("k", ["0"])[0]) or None
            except ValueError:
                return self._json(400, {"error": "bad k"})
            try:
                images = engine.search_by_image(body, k, query.get("ref", []))
            except ValueError as err:
                return self._json(400, {"error": str(err)})
            except Exception:
                log.exception("image search failed")
                return self._send(500, b"")
            self._send(200, engine.render_images_json(images))

        def _remove(self, body: bytes):
            try:
                req = json.loads(body)
                images = list(req["images"])
                restore = bool(req.get("restore", False))
            except Exception:
                return self._json(400, {"error": 'expected {"images": [...]}'})
            try:
                if restore:
                    return self._json(200, {"restored": engine.restore_images(images)})
                return self._json(200, {"removed": engine.remove_images(images)})
            except Exception:
                log.exception("remove failed")
                return self._send(500, b"")

        def _scan(self):
            with scan_lock:  # single-flight: concurrent scans would double-decode
                try:
                    stats = engine.scan()
                except Exception:
                    log.exception("Error embedding images")
                    return self._send(200, b"")  # the reference always answers 200
            if stats.embedded:
                # the corpus grew (a server that started empty warmed nothing)
                _spawn_warmup(engine, batcher)
            self._json(
                200,
                {
                    "found": stats.found,
                    "embedded": stats.embedded,
                    "skipped_existing": stats.skipped_existing,
                    "decode_failures": stats.decode_failures,
                    "pruned": stats.pruned,
                    "seconds": round(stats.seconds, 3),
                },
            )

        def _duplicates(self, query: dict):
            job_id = query.get("job")
            if job_id is not None:
                with jobs_lock:
                    job = jobs.get("last")
                if job is None or job.id != job_id:
                    return self._json(404, {"error": "unknown job"})
                if not job.done.is_set():
                    return self._json(
                        202, {"job": job_id, "state": "running", "progress": _dup_progress()}
                    )
                if job.failed:
                    return self._json(500, {"job": job_id, "state": "failed"})
                return self._json(
                    200, {"job": job_id, "state": "done", "groups": job.groups, "mode": job.mode}
                )
            try:
                threshold = float(query.get("threshold", "0.95"))
            except ValueError:
                return self._json(400, {"error": "bad threshold"})
            if not 0.0 < threshold <= 1.0:
                return self._json(400, {"error": "threshold must be in (0, 1]"})
            if query.get("async") in ("1", "true"):
                with jobs_lock:
                    job = jobs.get("last")
                    if job is not None and not job.done.is_set():
                        # joining is right only at the same threshold
                        if job.threshold != threshold:
                            return self._json(409, {
                                "error": f"duplicate scan already running at threshold {job.threshold}",
                                "job": job.id,
                                "threshold": job.threshold,
                            })
                        return self._json(
                            202, {"job": job.id, "state": "running", "progress": _dup_progress()}
                        )
                    job = jobs["last"] = _DupJob(threshold)
                    # the gauge still holds the last scan's 1.0 until the job starts
                    global_metrics.gauge("duplicate_scan_progress", 0.0)
                    threading.Thread(target=run_job, args=(job,), name="duplicates", daemon=True).start()
                return self._json(
                    202, {"job": job.id, "state": "running", "poll": f"/duplicates?job={job.id}"}
                )
            try:
                with dup_lock:
                    groups = engine.find_duplicate_groups(threshold)
                    mode = engine.last_duplicate_mode
            except Exception:
                log.exception("duplicate scan failed")
                return self._send(500, b"")
            self._json(200, {"groups": groups, "mode": mode})

        def _media(self, media_path: str):
            abs_path = engine.to_abs_path(media_path)
            if abs_path is None or not os.path.isfile(abs_path):
                return self._json(404, {"error": "not found"})
            self._file(abs_path)

        def _static(self, rel: str):
            root = os.path.realpath(static_dir)
            # realpath resolves "..", absolute parts and symlinks alike
            full = os.path.realpath(os.path.join(root, rel))
            if not full.startswith(root + os.sep) or not os.path.isfile(full):
                return self._json(404, {"error": "not found"})
            self._file(full)

        def _file(self, path: str):
            with open(path, "rb") as f:
                data = f.read()
            self._send(200, data, mimetypes.guess_type(path)[0] or "application/octet-stream")

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128  # the listen backlog (socketserver's 5 resets concurrent clients)
    batcher = None

    def server_close(self) -> None:
        super().server_close()
        if self.batcher is not None:
            self.batcher.stop()


def make_server(engine: SearchEngine, addr: str = "127.0.0.1", port: int = 0, static_dir=None,
                batch_window_ms: float = 0.0) -> ThreadingHTTPServer:
    """A bound server for ``engine`` (port 0 picks a free port); call
    ``serve_forever`` on it, and ``shutdown`` + ``server_close`` to stop.
    ``batch_window_ms`` > 0 starts the search batcher and the background
    warm-up (``server_close`` stops the batcher)."""
    batcher = SearchBatcher(engine, batch_window_ms) if batch_window_ms > 0 else None
    handler = _handler_class(engine, threading.Lock(), static_dir or CLIENT_DIR, batcher)
    server = _Server((addr, port), handler)
    if batcher is not None:
        server.batcher = batcher
        batcher.start()
        _spawn_warmup(engine, batcher)
    return server


def build_parser():
    p = server_args.build_parser()
    p.prog = "python -m image_search_tpu_torch.server.app"
    p.add_argument("--device", default="cuda", help="torch device to serve on (default cuda)")
    return p


def parse_args(argv=None):
    """-> (the reference's ServerArgs, device)."""
    ns = vars(build_parser().parse_args(argv))
    device = ns.pop("device")
    return server_args.ServerArgs(**ns), device


def main(argv=None) -> None:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args, device = parse_args(argv)
    engine = SearchEngine(args, device=device)
    server = make_server(engine, args.addr, args.port, args.static_dir, args.batch_window_ms)
    log.info("serving on http://%s:%d (media: %s)", args.addr, server.server_port, engine.media_dir)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
