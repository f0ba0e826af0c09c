#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``image_search_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on a failed check:

1. environment: the card's name and power limit, optional packages, the
   matmul-precision policy (no TF32);
2. build: compile ``image_search_tpu_torch/csrc/*.cu`` with nvcc;
3. each CUDA kernel against its plain PyTorch version at the main path's
   shapes, on the card, with CUDA-event times for both;
4. ViT-L/14 at full width (seeded random bf16 weights): preprocess + vision
   tower at B=160 and the text tower at B=8 through the attention kernel,
   checked against the same weights' f32 forward on the CPU, and img/s;
5. the HTTP server on 64 synthetic BMP photos with an int8 index: /scan,
   /search with and without Rocchio feedback (checked against the plain
   scoring of the same index), /health.

The second-to-last line is a JSON object describing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``. Without a GPU the
script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
ATTN_MAX_ABS = 2e-2  # bf16 kernel vs bf16 plain version (output values are O(1))
ATTN_MIN_COS = 0.9999  # per head vector, bf16 kernel vs f32 plain version
TOWER_MIN_COS = 0.99  # bf16 on the card vs f32 on the CPU over 24 layers


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2):
    """Per-call CUDA-event times (ms) of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def ab_ms(torch, plain, kernel, iters: int):
    """Median ms of both versions, timed in turns: plain, kernel, kernel, plain."""
    p = cuda_ms(torch, plain, iters)
    k = cuda_ms(torch, kernel, iters) + cuda_ms(torch, kernel, iters)
    p += cuda_ms(torch, plain, iters)
    return statistics.median(k), statistics.median(p)


def phase_kernels(torch, gen, dev):
    from image_search_tpu_torch.ops.attention import attention_reference, fused_attention
    from image_search_tpu_torch.ops.score_stream import (
        NEG_INF, quantize_rows_int8, scores_int8_reference, stream_scores_int8,
    )

    F = torch.nn.functional
    res = {}
    for B, S, H, causal in ((160, 257, 16, False), (32, 77, 12, True)):
        D, Hd = H * 64, 64
        # the tower's layout: q scaled and contiguous, k and v strided column
        # blocks of one fused qkv projection
        qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
        q = qkv[..., :D] * 0.125
        k, v = qkv[..., D : 2 * D], qkv[..., 2 * D :]
        got = fused_attention(q, k, v, H, causal)
        torch.cuda.synchronize()
        split = lambda t: t.reshape(B, S, H, Hd)
        want = attention_reference(split(q), split(k), split(v), causal).reshape(B, S, D)
        want32 = attention_reference(
            split(q).float(), split(k).float(), split(v).float(), causal
        ).reshape(B, S, D)
        err = (got.float() - want.float()).abs().max().item()
        cos = F.cosine_similarity(
            got.float().reshape(-1, Hd), want32.reshape(-1, Hd), dim=-1
        ).min().item()
        check(err <= ATTN_MAX_ABS, f"attention B={B} S={S}: max abs err {err} > {ATTN_MAX_ABS}")
        check(cos >= ATTN_MIN_COS, f"attention B={B} S={S}: min cosine {cos} < {ATTN_MIN_COS}")
        k_ms, p_ms = ab_ms(
            torch,
            lambda: attention_reference(split(q), split(k), split(v), causal),
            lambda: fused_attention(q, k, v, H, causal),
            iters=10,
        )
        res[("attention", S)] = dict(max_abs_err=err, min_cos=cos, ms=k_ms, plain_ms=p_ms, B=B, S=S, H=H)
        print(
            f"B1 attention B={B} S={S} H={H} Hd=64 causal={causal}: max_abs_err={err} "
            f"min_cos_vs_f32={cos} kernel_ms={k_ms} plain_ms={p_ms}"
            + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
        )
        del qkv, q, k, v, got, want, want32

    N, D = 1_000_000, 768
    rows, scales = quantize_rows_int8(F.normalize(torch.randn(N, D, generator=gen, device=dev), dim=-1))
    pens = torch.zeros(N, device=dev)
    pens[torch.randint(0, N, (1000,), generator=gen, device=dev)] = NEG_INF
    limit = N - 12_345
    for B in (1, 8):
        qi, qs = quantize_rows_int8(F.normalize(torch.randn(B, D, generator=gen, device=dev), dim=-1))
        for pen in (None, pens):
            got = stream_scores_int8(rows, qi, qs, scales, limit, pen)
            want = scores_int8_reference(rows, qi, qs, scales, limit, pen)
            check(torch.equal(got, want), f"int8 scores B={B} pens={pen is not None}: not bitwise equal")
            err = (got - want).abs().max().item()
            k_ms, p_ms = ab_ms(
                torch,
                lambda: scores_int8_reference(rows, qi, qs, scales, limit, pen),
                lambda: stream_scores_int8(rows, qi, qs, scales, limit, pen),
                iters=10,
            )
            res[("score", B, pen is not None)] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
            gbs = N * D / (k_ms * 1e-3) / 1e9
            print(
                f"B2 int8 scores N={N} D={D} B={B} pens={pen is not None} limit={limit}: "
                f"bitwise_equal=True kernel_ms={k_ms} ({gbs:.1f} GB/s of rows) plain_ms={p_ms}"
                + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
            )
    del rows, scales, pens
    torch.cuda.empty_cache()
    return res


def phase_towers(torch, gen, dev, smi):
    import numpy as np

    from image_search_tpu.config import get_config
    from image_search_tpu.tokenizer import HashTokenizer
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.ops.attention import fused_attention
    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch

    F = torch.nn.functional
    cfg = get_config("clip-vit-large-patch14")
    state = init_params(cfg, gen, dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(160)]
    u8, A_h, A_w = (torch.from_numpy(a) for a in pack_batch(images, size=cfg.vision.image_size))
    u8_d, A_h_d, A_w_d = (t.to(dev) for t in (u8, A_h, A_w))
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    ids = torch.from_numpy(tok([f"a photo of thing number {i}" for i in range(8)]).astype(np.int64))

    def vision():
        return encode_image(model, fused_preprocess(u8_d, A_h_d, A_w_d, out_dtype=torch.bfloat16))

    with torch.inference_mode():
        n0 = fused_attention.launches
        img = vision()
        n1 = fused_attention.launches
        txt = encode_text(model, ids.to(dev))
        n2 = fused_attention.launches
        torch.cuda.synchronize()
        L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
        check(n1 - n0 == L_v, f"vision forward launched the attention kernel {n1 - n0} times, want {L_v}")
        check(n2 - n1 == L_t, f"text forward launched the attention kernel {n2 - n1} times, want {L_t}")
        check(img.shape == (160, cfg.projection_dim) and bool(torch.isfinite(img).all()), "bad image embeddings")
        check(txt.shape == (8, cfg.projection_dim) and bool(torch.isfinite(txt).all()), "bad text embeddings")

        cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
        img32 = encode_image(cpu, fused_preprocess(u8[:4], A_h[:4], A_w[:4]))
        txt32 = encode_text(cpu, ids[:4])
        cos_i = F.cosine_similarity(img[:4].float().cpu(), img32, dim=-1).min().item()
        cos_t = F.cosine_similarity(txt[:4].float().cpu(), txt32, dim=-1).min().item()
        print(f"towers: vision launches/forward={n1 - n0} text launches/forward={n2 - n1}")
        print(f"towers: bf16 card vs f32 CPU min cosine: image={cos_i} text={cos_t} (bound {TOWER_MIN_COS})")
        check(cos_i >= TOWER_MIN_COS, f"image embeddings: cosine {cos_i} < {TOWER_MIN_COS}")
        check(cos_t >= TOWER_MIN_COS, f"text embeddings: cosine {cos_t} < {TOWER_MIN_COS}")
        del cpu, img32, txt32

        ms = statistics.median(cuda_ms(torch, vision, iters=5))
        txt_ms = statistics.median(cuda_ms(torch, lambda: encode_text(model, ids.to(dev)), iters=5))
    ips = 160 / (ms * 1e-3)
    print(
        f"towers: ViT-L/14 bf16 preprocess+vision B=160: {ms} ms/batch = {ips} img/s; "
        f"text tower B=8: {txt_ms} ms  [{smi}]"
    )
    del model, state
    torch.cuda.empty_cache()
    return {"img_per_s": ips, "vision_ms": ms, "text_ms": txt_ms, "cos_image": cos_i, "cos_text": cos_t}


def _http(method: str, url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, raw = r.status, r.read()
    return status, json.loads(raw), (time.perf_counter() - t0) * 1e3


def _plain_top(torch, engine, query: str, refs, k: int):
    """The plain scoring of the engine's own index for one request."""
    from image_search_tpu_torch.index.index import _rocchio_queries
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8, scores_int8_reference

    idx = engine.index
    with idx._lock:
        slabs, norms, scales, _ = idx._snapshot()
        size = idx._size
        sel = [idx._row[engine._resolve_selection(m)] for m in refs] or [-1]
    text = engine._cache_get(query).float().reshape(1, -1)
    q = _rocchio_queries(slabs, scales, norms, text, torch.tensor([sel], device=text.device))
    qi, qs = quantize_queries_int8(q)
    parts, start = [], 0
    for slab, sc in zip(slabs, scales):
        parts.append(scores_int8_reference(slab, qi, qs, sc, size - start))
        start += slab.shape[0]
    scores = torch.cat(parts, dim=1)
    v, i = torch.topk(scores, min(k, size), dim=-1)
    return v[0].cpu().tolist(), [idx.paths[j] for j in i[0].cpu().tolist()]


def phase_server(torch, dev, model: str = "clip-vit-large-patch14"):
    import numpy as np

    from image_search_tpu_torch.ingest.decode import write_bmp24
    from image_search_tpu_torch.ops.attention import fused_attention
    from image_search_tpu_torch.ops.score_stream import stream_scores_int8
    from image_search_tpu_torch.server.app import make_server, parse_args
    from image_search_tpu_torch.server.engine import SearchEngine

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        media = os.path.join(tmp, "photos")
        os.makedirs(os.path.join(media, "sub"))
        rng = np.random.default_rng(1)
        for i in range(64):
            h, w = (int(x) for x in rng.integers(64, 640, 2))
            img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
            y, x = h // 4, w // 4
            img[y : 3 * y, x : 3 * x] = rng.integers(0, 256, 3)  # a square
            write_bmp24(os.path.join(media, "sub" if i % 4 == 0 else "", f"photo_{i:02d}.bmp"), img)
        args, device = parse_args([
            "--media-dir", media, "--index-dir", os.path.join(tmp, "index"),
            "--index-quantize", "int8", "--model", model,
            "--model-weights", os.path.join(tmp, "no-checkpoint.safetensors"),
            "--device", str(dev),
        ])
        engine = SearchEngine(args, device=device)
        server = make_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_port}"
        try:
            fused_attention.launches = 0
            stream_scores_int8.launches = 0
            st, scan, scan_ms = _http("GET", base + "/scan")
            st1, plain, ms1 = _http("POST", base + "/search", {"q": "a red square", "referenced_images": []})
            marked = [plain["images"][0]["image_path"], plain["images"][5]["image_path"]]
            st2, fb, ms2 = _http("POST", base + "/search", {"q": "a red square", "referenced_images": marked})
            st3, health, ms3 = _http("GET", base + "/health")
            launches = {"attention": fused_attention.launches, "score": stream_scores_int8.launches}
            torch.cuda.synchronize()

            check(st == 200 and scan["embedded"] == 64 and scan["decode_failures"] == 0, f"/scan: {scan}")
            k = min(args.k, 64)
            for name, s, body in (("plain", st1, plain), ("feedback", st2, fb)):
                check(s == 200 and set(body) == {"images"}, f"/search {name}: status {s}, keys {set(body)}")
                imgs = body["images"]
                check(len(imgs) == k, f"/search {name}: {len(imgs)} images, want {k}")
                for d in imgs:
                    check(set(d) == {"id", "image_path", "score"}, f"/search {name}: row keys {set(d)}")
                    check(d["image_path"].startswith("media/"), f"/search {name}: path {d['image_path']}")
                    check(d["id"] == urllib.parse.quote(d["image_path"], safe=""), f"/search {name}: id {d['id']}")
            check(st3 == 200 and health["status"] == "ok" and health["corpus"] == 64, f"/health: {health}")
            check(launches["attention"] > 0 and launches["score"] > 0, f"kernels not on the path: {launches}")
            check([d["score"] for d in plain["images"]] != [d["score"] for d in fb["images"]],
                  "feedback did not move the query")

            # the answers against the plain scoring of the same index
            for name, body, refs in (("plain", plain, []), ("feedback", fb, marked)):
                want_s, want_p = _plain_top(torch, engine, "a red square", refs, k)
                got_s = [d["score"] for d in body["images"]]
                got_p = [engine.to_abs_path(d["image_path"]) for d in body["images"]]
                check(got_s == want_s, f"/search {name}: scores differ from the plain scoring")
                distinct = [j for j in range(k) if got_s.count(got_s[j]) == 1]
                check(all(got_p[j] == want_p[j] for j in distinct), f"/search {name}: ids differ")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    print(
        f"server: /scan embedded {scan['embedded']} photos in {scan['seconds']} s = "
        f"{scan['embedded'] / scan['seconds']} img/s (request {scan_ms} ms); "
        f"/search plain {ms1} ms, feedback {ms2} ms, /health {ms3} ms"
    )
    print(f"server: kernel launches in the main-path run: {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import image_search_tpu_torch
    from image_search_tpu_torch import _build

    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    for mod in ("aiohttp", "safetensors", "PIL", "triton"):
        try:
            __import__(mod)
            print(f"optional package {mod}: importable")
        except ImportError:
            print(f"optional package {mod}: absent")
    image_search_tpu_torch.check_precision()
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.2f} s "
          f"({'compiled' if _build.build_seconds is not None else 'cached'})")
    _build.lib()

    gen = torch.Generator(device=dev).manual_seed(0)
    kern = phase_kernels(torch, gen, dev)
    towers = phase_towers(torch, gen, dev, smi)
    launches = phase_server(torch, dev)
    check("jax" not in sys.modules, "the port imported jax")

    attn = kern[("attention", 257)]
    score = kern[("score", 1, False)]
    print(json.dumps({"kernels": [
        {"name": "fused_attention", "route": "cuda",
         "source": "image_search_tpu_torch/csrc/attention.cu",
         "replaces": "image_search_tpu/ops/attention.py:665",
         "launches": launches["attention"],
         "max_abs_err": max(kern[("attention", 257)]["max_abs_err"], kern[("attention", 77)]["max_abs_err"]),
         "ms": attn["ms"], "plain_ms": attn["plain_ms"]},
        {"name": "stream_scores_int8", "route": "cuda",
         "source": "image_search_tpu_torch/csrc/score_stream.cu",
         "replaces": "image_search_tpu/ops/score_stream.py:67",
         "launches": launches["score"],
         "max_abs_err": max(v["max_abs_err"] for key, v in kern.items() if key[0] == "score"),
         "ms": score["ms"], "plain_ms": score["plain_ms"]},
    ], "img_per_s": towers["img_per_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
