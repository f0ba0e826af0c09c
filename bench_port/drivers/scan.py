"""``GET /scan`` of a phone-photo library into an empty index.

Set-up: the engine on the configuration's flags and the harness's weights,
its server (``make_server``), the pool of JPEGs made from the seed; a first
``/scan`` of two chunks of the library warms every shape the scan uses (the
decode pool, the embedder's buckets, the index's appends) and the batcher's
warm-up that follows a scan; then the rest of the library is linked in and
the measured ``/scan`` starts. The window opens when its first chunk has
been appended to the index and closes at the first append ``--seconds``
later: ``scan_img_per_s`` is the rows appended after the opening append up
to the closing one, over the time between them. The run then removes the
library's links, so the scan runs out at once, and waits for it.

Correct: sampled photos of the window, the index's stored raw vectors
against the plain reference (PIL's decode and resize, the f32 vision tower,
the int8 row the configuration states).
"""

from __future__ import annotations

import json
import logging
import os
import random
import shutil
import sys
import threading
import time
import urllib.request

import numpy as np

from bench_port import gen_photos, harness, weights
from bench_port.drivers import common
from bench_port.reference import clip as ref_clip
from bench_port.reference.search import quantize
from bench_port.trace import Tracer


class _Appends:
    """``engine.index.add`` stamped: (host time after the call, rows added,
    paths)."""

    def __init__(self, index):
        self.log, self.lock = [], threading.Lock()
        inner = index.add

        def add(paths, embeddings):
            n = inner(paths, embeddings)
            with self.lock:
                self.log.append((time.perf_counter(), n, list(paths)))
            return n

        index.add = add

    def snapshot(self):
        with self.lock:
            return list(self.log)


class _AttnShapes:
    """Attention forwards (B, S, H, Hd, causal) in the window: the model's
    ``AttentionCore`` swapped for a recorder in traced runs."""

    def __init__(self, torch):
        from image_search_tpu_torch.models import clip as clip_mod

        self.calls, self.on = [], False
        self._mod, core = clip_mod, clip_mod.AttentionCore
        recorder = self

        class Recording:
            @staticmethod
            def apply(q, k, v, heads, causal, sm_scale, route="grouped", s_real=None):
                if recorder.on:
                    B, S, D = q.shape
                    recorder.calls.append((B, S, heads, D // heads, bool(causal), torch.is_grad_enabled()))
                return core.apply(q, k, v, heads, causal, sm_scale, route, s_real)

        self._core = core
        clip_mod.AttentionCore = Recording

    def restore(self):
        self._mod.AttentionCore = self._core


def _get(url: str, timeout: float = 3600.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _measure(torch, cell: common.Cell) -> dict:
    """The set-up and the measured scan -> what run() and control() need."""
    mix, device = cell.mix, cell.device
    common.quiet_program_logs()
    lib, pool_dir = os.path.join(cell.tmp, "library"), os.path.join(cell.tmp, "pool")
    index_dir = os.path.join(cell.tmp, "index")
    os.makedirs(lib)
    engine, args = common.build_engine(torch, cell, lib, index_dir)
    shapes = gen_photos.sizes(mix["pool"], mix["long_side"], mix["short_side"], mix["portrait_share"])
    pool = gen_photos.write_pool(torch, cell.seed, pool_dir, shapes, mix["grain"], mix["jpeg_quality"], device)
    from image_search_tpu_torch.server import app

    srv = app.make_server(engine, "127.0.0.1", 0, batch_window_ms=args.batch_window_ms)
    serve = threading.Thread(target=srv.serve_forever, name="bench-http", daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    warm = mix["warm_chunks"] * args.chunk_size
    gen_photos.library(lib, pool, 0, warm)
    status, body = _get(base + "/scan")
    if status != 200 or json.loads(body)["embedded"] != warm:
        raise RuntimeError(f"warm-up /scan answered {status} {body[:200]!r}")
    common.join_threads("serving-warmup")
    total = int(mix["max_img_per_s"] * (cell.seconds + mix["lead_s"]))
    gen_photos.library(lib, pool, warm, total)
    appends = _Appends(engine.index)
    shapes_rec = _AttnShapes(torch) if cell.trace else None
    tracer = Tracer(torch, cell.trace)
    tracer.start()
    scan_out: dict = {}

    def scan():
        try:
            scan_out["status"], scan_out["body"] = _get(base + "/scan")
        except Exception as err:  # reported below
            scan_out["error"] = repr(err)

    scanner = threading.Thread(target=scan, name="bench-scan")
    scanner.start()
    try:
        while not appends.snapshot() and scanner.is_alive():
            time.sleep(0.001)
        log = appends.snapshot()
        if not log:
            raise RuntimeError(f"the measured /scan appended nothing: {scan_out}")
        t_open = log[0][0]
        setup_s = t_open - cell.start
        if shapes_rec:
            shapes_rec.on = True
        with tracer.window():
            while scanner.is_alive():
                log = appends.snapshot()
                if log[-1][0] >= t_open + cell.seconds:
                    break
                time.sleep(0.002)
        if shapes_rec:
            shapes_rec.on = False
        tracer.stop()
    finally:
        if shapes_rec:
            shapes_rec.restore()
        logging.getLogger("image_search_tpu_torch.ingest").setLevel(logging.CRITICAL)
        shutil.rmtree(lib, ignore_errors=True)  # the scan runs out of photos
        scanner.join(600)
    log = appends.snapshot()
    close = next((e for e in log[1:] if e[0] >= t_open + cell.seconds), None)
    if close is None:
        raise RuntimeError(f"the library ran out before the window closed ({len(log)} appends)")
    win = [e for e in log[1:] if e[0] <= close[0]]
    appended = sum(n for _, n, _ in win)
    span = close[0] - t_open
    failed = sum(max(0, args.chunk_size - n) for _, n, _ in win)
    summary = tracer.summary()
    common.join_threads("serving-warmup")
    peak = common.peak_bytes(torch, device)
    rng = random.Random(cell.seed)
    sample_pool = sorted(rng.sample(range(len(pool)), min(mix["check_photos"], len(pool))))
    first = {}
    for _, _, paths in win:
        for p in paths:
            first.setdefault(gen_photos.pool_index(p, len(pool)), p)
    picked = [(j, first.get(j)) for j in sample_pool]
    stored = {j: engine.index.get_raw_embeddings([p]) for j, p in picked if p is not None}
    srv.shutdown()
    srv.server_close()
    serve.join(30)
    del engine, srv
    common.free(torch, device)
    missing = sum(1 for j, _ in picked if j not in stored or stored[j].shape[0] != 1)
    print(f"scan: {appended} photos in {span} s of window, {len(win)} appends; set-up {setup_s} s; "
          f"scan answered {scan_out.get('status')}", file=sys.stderr)
    return {"appended": appended, "span": span, "failed": failed, "setup_s": setup_s, "summary": summary,
            "peak": peak, "pool": pool, "stored": stored, "missing": missing,
            "attn_calls": shapes_rec.calls if shapes_rec else []}


def run(cell: common.Cell) -> harness.Result:
    import torch

    out = _measure(torch, cell)
    checks, correct = _check(torch, cell, out["pool"], out["stored"], out["missing"])
    summary = out["summary"]
    context = {"appended": out["appended"], "window_s": out["span"], "trace": summary, "model": cell.model,
               "attn_calls": out["attn_calls"]}
    return harness.Result(
        end_to_end={"scan_img_per_s": out["appended"] / out["span"], "setup_s": out["setup_s"]}, context=context,
        correct=correct and out["failed"] == 0, checks=checks, attempted=out["appended"] + out["failed"],
        failed=out["failed"],
        device=harness.device_record(torch, cell.device, 1, out["peak"]) | (
            {"busy_s": summary["busy_s"], "window_s": summary["window_s"]} if summary else {}),
        breakdown=summary["breakdown"] if summary else None,
    )


def control(cell: common.Cell) -> dict:
    """One run of the cell, then the control in the program's place: the
    reference tower in fp8 with int4 rows, for the same sampled photos."""
    import torch

    out = _measure(torch, cell)
    checks, correct = _check(torch, cell, out["pool"], out["stored"], out["missing"])
    want = reference_rows(torch, cell, out["pool"], sorted(out["stored"]))
    low = reference_rows(torch, cell, out["pool"], sorted(out["stored"]), lowp=True)
    err = max(_rel_err(low[j], want[j]) for j in want)
    ctrl = {"missing": {"value": 0, "limit": 0},
            "emb_rel_err": {"value": err, "limit": cell.mix["limits"]["emb_rel_err"]}}
    return {"program": checks, "program_correct": correct, "control": ctrl,
            "control_correct": all(c["value"] <= c["limit"] for c in ctrl.values())}


def reference_rows(torch, cell: common.Cell, pool: list, which: list, lowp: bool = False) -> dict:
    """{pool index: the raw vector the index should store}: the reference
    tower's raw embedding, l2-normalised, rounded to int8 with one scale
    (int4 for the control), times its norm."""
    m = cell.model
    state = weights.make(m, cell.seed, cell.device, torch.bfloat16
                         if torch.device(cell.device).type == "cuda" else torch.float32)
    px = torch.stack([ref_clip.preprocess(pool[j], m["vision"]["image_size"]) for j in which]).to(cell.device)
    with torch.no_grad(), ref_clip.f32_exact():
        raw = ref_clip.Clip(m, state, lowp="fp8" if lowp else None).encode_image(px)
        norms = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
        q, s = quantize(raw / norms, 7 if lowp else 127)
        rows = q * s[:, None] * norms
    return {j: rows[n].cpu().numpy() for n, j in enumerate(which)}


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check(torch, cell: common.Cell, pool: list, stored: dict, missing: int):
    want = reference_rows(torch, cell, pool, sorted(stored))
    err = max((_rel_err(stored[j][0], want[j]) for j in stored), default=0.0)
    checks = {
        "missing": {"value": missing, "limit": 0},
        "emb_rel_err": {"value": err, "limit": cell.mix["limits"]["emb_rel_err"]},
    }
    return checks, all(c["value"] <= c["limit"] for c in checks.values())
