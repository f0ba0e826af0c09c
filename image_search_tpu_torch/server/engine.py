"""SearchEngine: model + tokenizer + index + scan pipeline on one device.

Port of ``image_search_tpu/server/engine.py::SearchEngine``: load the
checkpoint (or seeded random demo weights), scan a media directory into the
index, answer text searches with optional Rocchio feedback through one
batched program, and query-by-image searches (``search_by_image``), rendering
the reference's wire format byte for byte, and find near-duplicate photo
groups by the reference's three routes (``find_duplicate_groups``). With
``--search-twostage`` the index keeps a corpus sketch (built at startup for
restored rows and after every scan that embedded rows) and searches take the
certified two-stage path: an all-cold batch as one queued tokens -> text
tower -> Rocchio -> two-stage run, other batches through the two-stage
feedback batch; the answers are the full scan's either way. With
``--search-approx`` searches skip the fused and two-stage paths and take the
index's approximate top-k (answered exactly, in ``lax.top_k``'s order).
``remove_images`` / ``restore_images`` serve ``POST /remove``; with
``--prune-on-scan`` a scan tombstones photos whose files are gone;
``--thumb-cache`` decodes from cached tiles; ``warm_serving_buckets`` runs
each serving shape once before live traffic (``--batch-window-ms``).

With ``--from-hf`` and no checkpoint file, the engine converts a local HF
directory (or fetches a hub id through ``transformers``) into the
checkpoint at startup; a failure degrades to a warning, as in the
reference.

The engine runs on an explicit device (default ``cuda``). Flags for what is
not ported yet raise at construction: meshes and the profiler.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.parse
from typing import List, Optional, Sequence

import numpy as np
import torch

from image_search_tpu_torch import _build, check_precision
from image_search_tpu_torch.config import get_config
from image_search_tpu_torch.index.index import NEG_INF, EmbeddingStore, VectorIndex
from image_search_tpu_torch.ingest.decode import decode_image_bytes
from image_search_tpu_torch.ingest.pipeline import ScanStats, scan_directory
from image_search_tpu_torch.models.convert import (
    HF_REPOS, build_model, convert_hf_model, init_params, load_checkpoint, params_from_jax,
)
from image_search_tpu_torch.models.embedder import ClipEmbedder
from image_search_tpu_torch.server.args import ServerArgs
from image_search_tpu_torch.tokenizer import CLIPBPETokenizer, HashTokenizer
from image_search_tpu_torch.utils.metrics import global_metrics, span

log = logging.getLogger(__name__)

MEDIA_PREFIX = "media/"
DEMO_SEED = 0


def unsupported_flags(args) -> List[str]:
    """Reference flags this port cannot serve yet, as they were given."""
    out = []
    if args.mesh_data is not None or args.mesh_model != 1:
        out.append("--mesh-data/--mesh-model")
    if args.profiler_port is not None:
        out.append("--profiler-port")
    return out


class SearchEngine:
    WIRE_CACHE_MAX = 1_000_000  # memo entries before a wholesale clear

    def __init__(self, args, device="cuda"):
        bad = unsupported_flags(args)
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        self.device = torch.device(device)
        self.last_duplicate_mode: Optional[str] = None
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        check_precision()
        self.args = args
        self.media_dir = os.path.normpath(os.path.abspath(args.expanded_media_dir()))
        self.cfg, model = self._load_model()
        self.embedder = ClipEmbedder(
            model, tokenizer=self._load_tokenizer(), preprocess_mode=args.preprocess_mode
        )
        self._text_cache: dict = {}
        self._text_lock = threading.Lock()
        self._wire_cache: dict = {}
        self._frag_cache: dict = {}
        self.thumb_cache = None
        if args.thumb_cache:
            from image_search_tpu_torch.ingest.thumbcache import ThumbCache

            self.thumb_cache = ThumbCache(args.thumb_cache)
            log.info("thumbnail cache enabled at %s", args.thumb_cache)
        store = EmbeddingStore(args.index_dir, self.cfg.projection_dim)
        self._excluded = store.excluded_paths()
        self.index = VectorIndex(
            self.cfg.projection_dim, device=self.device, store=store,
            quantize=args.index_quantize, capacity=args.index_capacity,
        )
        if args.search_twostage and len(self.index):
            self._build_sketch()  # restored rows: the certified path from query 1
        log.info(
            "engine ready: model=%s dim=%d corpus=%d device=%s",
            self.cfg.name, self.cfg.projection_dim, len(self.index), self.device,
        )

    # -- construction ---------------------------------------------------------

    def _compute_dtype(self) -> torch.dtype:
        choice = self.args.compute_dtype
        if choice == "auto":
            return torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if choice == "float32" and self.device.type == "cuda":
            raise NotImplementedError("not ported yet: --compute-dtype float32 on cuda (bf16 kernels)")
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[choice]

    def _fetch_hf(self, path: str) -> None:
        """--from-hf with no checkpoint at ``path``: convert the HF model into
        one (``auto``: the preset's hub repo), and give a tokenizer directory
        without ``vocab.json`` the model's BPE files; a failure (offline, no
        ``transformers``, a bad directory) is a warning."""
        ref = self.args.from_hf
        if ref == "auto":
            ref = HF_REPOS.get(self.args.model, self.args.model)
        tok = self.args.tokenizer_dir
        tok_out = tok if tok and not os.path.exists(os.path.join(tok, "vocab.json")) else None
        try:
            log.info("--from-hf: converting %s -> %s", ref, path)
            convert_hf_model(ref, path, preset=self.args.model, tokenizer_out=tok_out)
        except Exception as err:
            log.warning("--from-hf %s failed (%s); continuing without", ref, err)

    def _load_model(self):
        dtype = self._compute_dtype()
        path = self.args.model_weights
        if not os.path.exists(path) and self.args.from_hf:
            self._fetch_hf(path)
        if os.path.exists(path):
            params, cfg = load_checkpoint(path)
            log.info("loaded checkpoint %s (%s)", path, cfg.name)
            return cfg, build_model(cfg, params_from_jax(params, cfg), self.device, dtype)
        cfg = get_config(self.args.model)
        log.warning(
            "checkpoint %s not found — using RANDOM %s weights (demo mode; "
            "searches will not be semantic)", path, cfg.name,
        )
        gen = torch.Generator(device=self.device).manual_seed(DEMO_SEED)
        return cfg, build_model(cfg, init_params(cfg, gen, self.device, dtype), self.device, dtype)

    def _load_tokenizer(self):
        d = self.args.tokenizer_dir
        if d and os.path.exists(os.path.join(d, "vocab.json")):
            log.info("loaded BPE tokenizer from %s", d)
            return CLIPBPETokenizer.from_dir(d, self.cfg.text.context_length)
        if d:
            log.warning("tokenizer dir %s missing vocab.json", d)
        log.warning("no tokenizer files — using deterministic hash tokenizer")
        return HashTokenizer(
            self.cfg.text.vocab_size, self.cfg.text.context_length,
            eos_id=self.cfg.text.eos_token_id,
        )

    # -- path mapping (media/ URL <-> absolute path) ----------------------------

    def to_abs_path(self, media_path: str) -> Optional[str]:
        """'media/x/y.jpg' -> '<media_dir>/x/y.jpg'; rejects non-media/ paths
        and directory traversal. Paths arrive verbatim (no unquoting)."""
        if not media_path.startswith(MEDIA_PREFIX):
            return None
        abs_path = os.path.normpath(os.path.join(self.media_dir, media_path[len(MEDIA_PREFIX):]))
        if not abs_path.startswith(os.path.normpath(self.media_dir) + os.sep):
            return None
        return abs_path

    def _abs_candidates(self, media_path: str) -> List[str]:
        """The raw string first, then its urldecoded form (a client may echo
        the urlencoded ``id`` instead of ``image_path``)."""
        out: List[str] = []
        abs_raw = self.to_abs_path(media_path)
        if abs_raw is not None:
            out.append(abs_raw)
        unquoted = urllib.parse.unquote(media_path)
        if unquoted != media_path:
            abs_unq = self.to_abs_path(unquoted)
            if abs_unq is not None and abs_unq not in out:
                out.append(abs_unq)
        return out

    def _resolve_selection(self, media_path: str) -> Optional[str]:
        cands = self._abs_candidates(media_path)
        for c in cands:
            if self.index.has_path(c):
                return c
        return cands[0] if cands else None

    def to_media_path(self, abs_path: str) -> str:
        rel = os.path.relpath(abs_path, os.path.normpath(self.media_dir))
        return MEDIA_PREFIX + rel.replace(os.sep, "/")

    # -- operations -------------------------------------------------------------

    def _build_sketch(self) -> None:
        self.index.build_sketch(
            dtype=self.args.sketch_dtype, min_certifiable=self.args.twostage_min_certifiable,
            est_k=self.args.k,
        )

    def _publish_twostage_gauges(self) -> None:
        global_metrics.gauge("twostage_certified_total", float(self.index.twostage_certified))
        global_metrics.gauge("twostage_fallback_total", float(self.index.twostage_fallbacks))
        global_metrics.gauge("twostage_sketch_active", float(self.index.sketch_fresh))
        global_metrics.gauge("twostage_sketch_incremental_total", float(self.index.sketch_incremental))
        global_metrics.gauge("twostage_gate_skips_total", float(self.index.twostage_gate_skips))
        if self.index.sketch_certifiable_est is not None:
            global_metrics.gauge("twostage_certifiable_est", round(self.index.sketch_certifiable_est, 4))

    def search(self, query: str, referenced_images: Sequence[str] = (), k: Optional[int] = None):
        """The ``web_search_text`` flow (search.rs:20-102): a batch of one."""
        return self.search_many([query], [referenced_images], k or self.args.k)[0]

    def search_by_image(self, image_bytes: bytes, k: Optional[int] = None, referenced_images: Sequence[str] = ()):
        """Query-by-image (``POST /search_image``): decode the uploaded bytes,
        embed them with the vision tower at B=1, and search with that
        embedding in the text embedding's role (two-stage when on, Rocchio
        feedback with ``referenced_images``). ValueError on undecodable
        bytes."""
        k = k or self.args.k
        with span("image.decode"):
            arr = decode_image_bytes(image_bytes)
        if arr is None:
            raise ValueError("could not decode query image")
        with global_metrics.timer("image_embed"):
            emb = self.embedder.embed_images_async([arr], min_bucket=1)[:1]
        selected = [p for p in (self._resolve_selection(m) for m in referenced_images) if p is not None]
        approx = self.args.search_approx
        use_twostage = self.args.search_twostage and not approx and self.index.sketch_fresh
        with global_metrics.timer("index_search"):
            if selected and use_twostage:
                scores, idx = self.index.search_twostage_feedback_batch(emb, [selected], k)
                self._publish_twostage_gauges()
            elif selected:
                scores, idx = self.index.search_with_feedback(emb, selected, k, approx=approx)
            elif use_twostage:
                scores, idx = self.index.search_twostage(emb, k)
                self._publish_twostage_gauges()
            else:
                scores, idx = self.index.search(emb, k, approx=approx)
        global_metrics.inc("searches")
        global_metrics.inc("image_searches")
        if selected:
            global_metrics.inc("searches_with_feedback")
        return self._format_results(scores, idx)

    def search_many(self, queries, selections=None, k: Optional[int] = None):
        """B searches -- plain and Rocchio feedback alike -- as one text-tower
        batch and one index pass. Returns result lists in request order.

        With ``--search-twostage`` and a fresh sketch, a batch of at most
        ``--twostage-max-batch`` queries takes the two-stage path: when no
        query is in the text cache, the fused tokens -> tower -> Rocchio ->
        two-stage run (``_search_many_fused``); otherwise the two-stage
        feedback batch on the cached and new embeddings. ``--search-approx``
        turns both two-stage paths off. (The reference's other guard, no
        mesh, holds here always: a mesh raises at construction.)"""
        k = k or self.args.k
        queries = list(queries)
        with span("search.resolve"):
            sel_lists = [
                [p for p in (self._resolve_selection(m) for m in sel) if p is not None]
                for sel in (selections or [()] * len(queries))
            ]
            local = {}
            for q in queries:
                hit = self._cache_get(q)
                if hit is not None:
                    local[q] = hit
        n_feedback = sum(1 for s in sel_lists if s)
        approx = self.args.search_approx
        use_twostage = (
            self.args.search_twostage and not approx and self.index.sketch_fresh
            and len(queries) <= self.args.twostage_max_batch
        )
        if not local and use_twostage and self.embedder.tokenizer is not None:
            out = self._search_many_fused(queries, sel_lists, k)
            if out is not None:
                self._inc_search_metrics(len(queries), n_feedback)
                return out
        hits = sum(1 for q in queries if q in local)
        misses = list(dict.fromkeys(q for q in queries if q not in local))
        if misses:
            with span("search.text_tower"):
                embs = self.embedder.embed_texts_device(misses)  # stays on the device
            for b, q in enumerate(misses):
                local[q] = embs[b]
                self._cache_put(q, embs[b])
        global_metrics.inc("text_embed_cache_hits", hits)
        q_mat = torch.stack([local[q].float() for q in queries])
        with global_metrics.timer("index_search"):
            if use_twostage:
                scores, idx = self.index.search_twostage_feedback_batch(q_mat, sel_lists, k)
                self._publish_twostage_gauges()
            else:
                # the batched feedback program even for all-plain batches: an
                # empty selection IS the plain search, bitwise
                scores, idx = self.index.search_with_feedback_batch(q_mat, sel_lists, k, approx=approx)
        self._inc_search_metrics(len(queries), n_feedback)
        with span("search.format"):
            return [self._format_results(scores[b], idx[b]) for b in range(len(queries))]

    def _inc_search_metrics(self, n_queries: int, n_feedback: int) -> None:
        global_metrics.inc("searches", n_queries)
        global_metrics.inc("searches_with_feedback", n_feedback)
        if n_queries > 1:  # only true coalescing counts
            global_metrics.inc("batched_searches", n_queries)
            if n_feedback:
                global_metrics.inc("batched_feedback_searches", n_feedback)

    def _search_many_fused(self, queries, sel_lists, k):
        """The all-cold two-stage run (``VectorIndex.search_twostage_fused_tokens``):
        tokenize on the host, pad by REPEATING row 0 to a power of two from 1
        (a pad row of EOS would be another query and take a share of the
        union budget), fill the text cache from the run. A failed
        certificate runs the full-scan feedback batch on the embeddings the
        run made; the tower never runs twice. None when the path cannot
        serve (the caller's path answers)."""
        B = len(queries)
        ids = self.embedder.tokenizer(list(queries))
        bpad = 1 << (B - 1).bit_length() if B > 1 else 1
        if bpad > B:
            ids = np.concatenate([ids, np.repeat(ids[:1], bpad - B, axis=0)])
        with global_metrics.timer("index_search"):
            scores, idx, text = self.index.search_twostage_fused_tokens(
                self.embedder.encode_text_fn, ids, sel_lists, k
            )
        if text is None:
            return None
        text_dev = torch.from_numpy(text).to(self.device)
        for b, q in enumerate(queries):
            self._cache_put(q, text_dev[b])
        if scores is None:
            with global_metrics.timer("index_search"):
                scores, idx = self.index.search_with_feedback_batch(text, sel_lists, k)
        self._publish_twostage_gauges()
        global_metrics.inc("fused_searches", B)
        return [self._format_results(scores[b], idx[b]) for b in range(B)]

    def warm_serving_buckets(self, max_batch: int = 32) -> int:
        """Run every serving shape once before live traffic, so that no
        request pays for a first use on the card: the kernel library's load
        (its nvcc build on a cold cache), cuBLAS's handle and workspace, the
        caching allocator's growth at each batch bucket {8, 16, ...,
        ``max_batch``} of the text tower and the feedback program, with
        ``--search-twostage`` the two-stage batch and the fused token path
        at each share {1, 2, 4, ...} up to ``--twostage-max-batch``, and the
        query-by-image path (the vision tower at B=1 and the ingest bucket).
        The port compiles no programs ahead of time; each call runs eagerly
        once. The embedder is called directly, so no text-cache entry is
        left behind. Returns the number of batch buckets warmed; sets the
        ``serving_warmup_done`` gauge."""
        if self.device.type == "cuda":
            _build.lib()  # the kernels' first use: their build or load
        if len(self.index) == 0:
            global_metrics.gauge("serving_warmup_done", 1.0)
            return 0
        sizes, b = [], 8
        while True:
            sizes.append(min(b, max_batch))
            if b >= max_batch:
                break
            b *= 2
        dim, k, approx = self.cfg.projection_dim, self.args.k, self.args.search_approx
        for n in sizes:
            self.embedder.embed_texts_device([f"\0warm{n}_{i}" for i in range(n)])
            self.index.search_with_feedback_batch(np.zeros((n, dim), np.float32), [[] for _ in range(n)], k,
                                                  approx=approx)
        twostage_on = self.args.search_twostage and not approx and self.index.sketch_fresh
        if twostage_on:
            # by-construction certificate failures of the zero query must not
            # count toward the adaptive disable
            r, tmb = 1, max(1, self.args.twostage_max_batch)
            while True:
                self.index.search_twostage_feedback_batch(
                    np.zeros((r, dim), np.float32), [[] for _ in range(r)], k, count_failures=False
                )
                if self.embedder.tokenizer is not None:
                    ids = self.embedder.tokenizer([f"\0warm_fused_{i}" for i in range(r)])
                    self.index.search_twostage_fused_tokens(
                        self.embedder.encode_text_fn, ids, [[] for _ in range(r)], k, count_failures=False
                    )
                if r >= tmb:
                    break
                r *= 2
        zq = np.zeros((1, dim), np.float32)
        if twostage_on:
            self.index.search_twostage(zq, k, count_failures=False)
        else:
            self.index.search(zq, k, approx=approx)
        self.embedder.embed_images_async([np.zeros((256, 256, 3), np.uint8)], min_bucket=1)
        self.embedder.embed_images([np.zeros((512, 512, 3), np.uint8)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        global_metrics.gauge("serving_warmup_done", 1.0)
        log.info("serving warmup: %d batch buckets run", len(sizes))
        return len(sizes)

    def _wire_row(self, row: int) -> dict:
        """Memoized ``{"id", "image_path"}`` for an index row (id = urlencoded
        path); rows are append-only, so entries never go stale."""
        d = self._wire_cache.get(row)
        if d is None:
            media = self.to_media_path(self.index.paths[row])
            d = {"id": urllib.parse.quote(media, safe=""), "image_path": media}
            if len(self._wire_cache) >= self.WIRE_CACHE_MAX:
                self._wire_cache.clear()
            self._wire_cache[row] = d
        return d

    def render_images_json(self, images) -> bytes:
        """``{"images": [...]}`` body, byte-identical to ``json.dumps`` (and to
        the reference's renderer), with the id/path escaping memoized."""
        cache = self._frag_cache
        parts = []
        for d in images:
            i = d["id"]
            frag = cache.get(i)
            if frag is None:
                frag = json.dumps({"id": i, "image_path": d["image_path"]})[:-1]
                if len(cache) >= self.WIRE_CACHE_MAX:
                    cache.clear()
                cache[i] = frag
            parts.append(f'{frag}, "score": {d["score"]!r}}}')
        return ('{"images": [%s]}' % ", ".join(parts)).encode()

    def _format_results(self, scores_row, idx_row):
        idx_np = np.asarray(idx_row).reshape(-1)
        sc_np = np.asarray(scores_row).reshape(-1)
        # sentinel rows (k beyond the live corpus, tombstones) are never served
        keep = sc_np > NEG_INF / 2
        out = []
        for row, score in zip(idx_np[keep], sc_np[keep]):
            d = dict(self._wire_row(int(row)))
            d["score"] = float(score)
            out.append(d)
        return out

    # Text-tower output per query string, least-recently-used eviction.
    _TEXT_CACHE_CAP = 512

    def _cache_get(self, query: str):
        with self._text_lock:
            hit = self._text_cache.pop(query, None)
            if hit is not None:
                self._text_cache[query] = hit  # reinsert: LRU refresh
        return hit

    def _cache_put(self, query: str, emb) -> None:
        with self._text_lock:
            if len(self._text_cache) >= self._TEXT_CACHE_CAP:
                self._text_cache.pop(next(iter(self._text_cache)), None)
            self._text_cache[query] = emb

    def remove_images(self, media_paths) -> int:
        """``POST /remove``: tombstone the photos AND exclude them, so that a
        rescan does not bring them back while their files remain on disk.
        Returns the rows removed."""
        resolved = [p for p in (self._resolve_selection(m) for m in media_paths) if p is not None]
        n, removed = self.index.remove_paths_report(resolved, exclude=True)
        # only the rows really tombstoned become exclusions, not request
        # duplicates or paths the store never held
        self._excluded.update(removed)
        if n:
            global_metrics.inc("removed_images", n)
        # a path already pruned (its file vanished) has no live row, yet the
        # user's removal must still keep a rescan from re-adding it if the
        # file comes back; a rowless path counts only if its file exists or
        # it was tombstoned (in this process, or in the store's log), so
        # paths never indexed do not pollute the exclusions
        gone = set(removed)
        candidates = [p for p in dict.fromkeys(resolved) if p not in gone and p not in self._excluded]
        tombstoned: set = set()
        if any(not os.path.exists(p) for p in candidates):
            store = self.index.store
            tombstoned = store.tombstoned_paths() if store is not None else set()
        leftovers = [p for p in candidates if os.path.exists(p) or self.index.was_removed(p) or p in tombstoned]
        if leftovers:
            self._excluded.update(leftovers)
            if self.index.store is not None:
                self.index.store.exclude_paths(leftovers)
        return n

    def restore_images(self, media_paths) -> int:
        """Undo ``POST /remove`` exclusions (``image_path`` or the urlencoded
        ``id``): the next scan re-embeds the files. Returns the exclusions
        cleared."""
        if self.index.store is None:
            return 0
        excluded = self.index.store.excluded_paths()
        resolved = []
        for m in media_paths:
            cands = self._abs_candidates(m)
            # the candidate actually excluded (removed paths are no longer
            # in the index, so has_path cannot pick it)
            pick = next((c for c in cands if c in excluded), cands[0] if cands else None)
            if pick is not None:
                resolved.append(pick)
        if not resolved:
            return 0
        n = self.index.store.clear_exclusion(resolved)
        for p in resolved:
            self._excluded.discard(p)
        return n

    def prune_missing(self) -> int:
        """Tombstone indexed photos whose files no longer exist (one walk of
        the media tree, not a stat per row). Refuses when the tree looks
        unavailable -- missing, or yielding no image while the index holds
        rows -- so that an unmounted disk does not tombstone the corpus."""
        from image_search_tpu_torch.ingest.walk import iter_images

        live = self.index.live_paths()
        if not live:
            return 0
        if not os.path.isdir(self.media_dir):
            log.warning("prune skipped: media dir %s is missing/unmounted", self.media_dir)
            return 0
        found = set(iter_images(self.media_dir))
        if not found:
            log.warning(
                "prune skipped: media dir %s yielded no image while the index holds %d; "
                "treating it as unavailable, not emptied", self.media_dir, len(live),
            )
            return 0
        missing = [p for p in live if p not in found]
        n = self.index.remove_paths(missing) if missing else 0
        if n:
            global_metrics.inc("pruned_missing", n)
            log.info("pruned %d missing images from the index", n)
        return n

    def scan(self) -> ScanStats:
        """The ``GET /scan`` ingest (search.rs:104-126). Paths the store
        marks excluded (removed by the user) are not re-embedded. With
        ``--prune-on-scan`` photos whose files are gone are tombstoned; with
        ``--search-twostage`` a scan that embedded rows then rebuilds the
        sketch."""
        with global_metrics.timer("scan"):
            stats = scan_directory(
                self.embedder, self.index, self.media_dir,
                chunk_size=self.args.chunk_size, decode_workers=self.args.decode_workers,
                skip_paths=self._excluded, thumb_cache=self.thumb_cache,
            )
        if self.args.prune_on_scan:
            stats.pruned = self.prune_missing()
        if self.args.search_twostage and stats.embedded:
            with global_metrics.timer("sketch_build"):
                self._build_sketch()
        global_metrics.inc("scans")
        global_metrics.inc("images_embedded", stats.embedded)
        global_metrics.inc("decode_failures", stats.decode_failures)
        global_metrics.gauge("corpus_size", float(len(self.index)))
        global_metrics.gauge("last_scan_images_per_sec", round(stats.images_per_sec, 2))
        return stats

    # above this corpus size the legacy duplicate scan would default to an
    # approximate top-k, and a flat corpus takes the approximate sketch scan
    DUPLICATES_APPROX_ABOVE = 1_000_000
    # above this corpus size (or with a fresh sketch) the certified sketch
    # scan is tried first; below it the legacy scan is fast enough
    DUPLICATES_SKETCH_ABOVE = 200_000

    def find_duplicate_groups(self, threshold: float = 0.95, approx: Optional[bool] = None):
        """Near-duplicate photo groups (cosine >= threshold), as lists of
        'media/...' paths sorted largest group first: union-find over the
        pairs of ``_duplicate_pairs``. Publishes ``duplicate_scan_progress``
        (0..1) while running, and ``duplicate_scan_certified`` (1 when the
        pair set is complete) and sets ``last_duplicate_mode`` when done."""
        if approx is None:
            approx = len(self.index) > self.DUPLICATES_APPROX_ABOVE

        def _progress(done: int, total: int) -> None:
            global_metrics.gauge("duplicate_scan_progress", round(done / max(total, 1), 4))

        _progress(0, 1)
        with global_metrics.timer("duplicate_scan"):
            pairs, mode = self._duplicate_pairs(threshold, approx, _progress)
        # 'certified' and 'legacy_exact' pair sets are complete;
        # 'approximate' and 'legacy_approx' may miss pairs, never add one
        self.last_duplicate_mode = mode
        global_metrics.gauge(
            "duplicate_scan_certified", 1.0 if mode in ("certified", "legacy_exact") else 0.0
        )
        _progress(1, 1)
        parent: dict = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        for i, j, _ in pairs:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
        groups: dict = {}
        for i, j, _ in pairs:
            groups.setdefault(find(i), set()).update((i, j))
        out = [
            sorted(self.to_media_path(self.index.paths[r]) for r in members)
            for members in groups.values()
        ]
        out.sort(key=len, reverse=True)
        global_metrics.inc("duplicate_scans")
        return out

    def _duplicate_pairs(self, threshold: float, approx: bool, progress):
        """The certified sketch scan when it can serve; on a bailout at
        scales where the legacy scan takes hours, the approximate candidate
        scan; the legacy scan otherwise. Returns (pairs, mode) with mode in
        {'certified', 'approximate', 'legacy_exact', 'legacy_approx'}."""
        from image_search_tpu_torch.index.dupscan import DupScanBailout

        sketch_dtype = getattr(self.args, "sketch_dtype", "float32")
        if self.index.sketch_fresh or len(self.index) > self.DUPLICATES_SKETCH_ABOVE:
            if not self.index.sketch_fresh:
                # the certifiability gate may refuse publication (flat
                # corpus); the certified scan then bails out below
                self.index.build_sketch(
                    dtype=sketch_dtype,
                    min_certifiable=getattr(self.args, "twostage_min_certifiable", 0.5),
                )
            try:
                pairs = self.index.find_near_duplicates_sketch(threshold=threshold, progress=progress)
                global_metrics.gauge("duplicate_scan_sketch", 1.0)
                return pairs, "certified"
            except DupScanBailout as e:
                log.info("sketch duplicate scan bailed out (%s)", e)
            if len(self.index) > self.DUPLICATES_APPROX_ABOVE:
                built_ungated = False
                try:
                    if not self.index.sketch_fresh:
                        self.index.build_sketch(dtype=sketch_dtype, min_certifiable=0.0)
                        built_ungated = True
                    pairs = self.index.find_near_duplicates_candidates(
                        threshold=threshold, progress=progress
                    )
                    global_metrics.gauge("duplicate_scan_sketch", 1.0)
                    return pairs, "approximate"
                except DupScanBailout as e:
                    log.info("candidate duplicate scan bailed out (%s); legacy", e)
                finally:
                    if built_ungated:
                        # the gate refused this sketch; do not leave it published
                        self.index.drop_sketch()
        global_metrics.gauge("duplicate_scan_sketch", 0.0)
        pairs = self.index.find_near_duplicates(threshold=threshold, approx=approx, progress=progress)
        return pairs, ("legacy_approx" if approx else "legacy_exact")
