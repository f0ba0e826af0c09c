"""Device-resident exact-cosine vector index with Rocchio feedback.

Port of ``image_search_tpu/index/index.py::VectorIndex`` for one device, with
f32, bf16 or int8 rows:

- rows are stored l2-NORMALIZED next to their original norms, so the raw
  vectors the reference stores are ``row * norm`` and the Rocchio average is
  taken in raw space;
- appended rows are normalized (and quantized) where the index lives by
  ``ops.row_quant.normalize_rows_into``: on the card one kernel launch a
  chunk of at most ``_APPEND_ROWS`` rows within a slab, bitwise the
  reference's numpy host path; int8 rows are scored by kernel B2
  (``ops.score_stream.stream_scores_int8``), f32 and bf16 rows by one GEMM
  (plain XLA in the reference; ``ops.score_stream.float_scores``);
- rows live in slabs: the first doubles up to ``slab_rows``, then whole new
  slabs are added, so growth never copies the corpus; capacity grows in
  multiples of 4096 rows; searches read them as a ``slabs.Slabs`` snapshot;
- tombstones are additive score penalties (0 live, NEG_INF removed), passed
  to the scan only once a removal happened (``remove_paths``; with
  ``exclude=True`` the store also keeps rescans from re-adding the paths);
- ``approx=True`` searches are answered exactly, in ``lax.top_k``'s order:
  the reference's ``lax.approx_max_k`` computes exactly that off the TPU,
  and recall 1.0 meets its 0.95 target;
- ``from_store`` opens an ``EmbeddingStore`` directory the reference wrote;
- the corpus sketch (``build_sketch``, kept fresh across appends), the
  certified two-stage search that reads it (``search_twostage``, its
  Rocchio batch ``search_twostage_feedback_batch`` and the tokens -> text
  tower -> Rocchio -> two-stage serving path
  ``search_twostage_fused_tokens``; ``index/twostage.py``), and the three
  duplicate scans: the legacy batched self-search
  (``find_near_duplicates``), the certified sketch scan and the approximate
  candidate scan (``index/dupscan.py``).

Not ported yet (it raises): device meshes.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_search_tpu_torch.index import dupscan, twostage
from image_search_tpu_torch.index.slabs import Slabs, dequantized, l2
from image_search_tpu_torch.index.store import EmbeddingStore
from image_search_tpu_torch.ops.row_quant import normalize_rows_into
from image_search_tpu_torch.ops.score_stream import float_scores, quantize_queries_int8, stream_scores_int8
from image_search_tpu_torch.ops.topk import exact_topk, lax_topk
from image_search_tpu_torch.utils.metrics import span

log = logging.getLogger(__name__)

NEG_INF = float(torch.finfo(torch.float32).min)
_UPDATE_BLOCK = 4096  # rows per aligned append block
DEFAULT_SLAB_ROWS = 1 << 20  # rows per full slab (int8 x 768 = 0.77 GB)
_APPEND_ROWS = 16384  # raw rows on the device per transform launch (50 MB of f32 at D = 768)

QUANT_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _rocchio_queries(sl: Slabs, text_emb, sel_idx):
    """Reference Rocchio weighting (search.rs:60-67) in raw-vector space, for
    B queries at once: query = average(average(selected_raw), text_raw).
    ``sel_idx`` [B, m] holds global rows, -1 for none; a row with no
    selection gives 0.5 * text, which l2-normalizes to exactly the plain
    text query."""
    m = sel_idx.shape[1]
    mask = (sel_idx >= 0).float()
    raw = dequantized(sl, torch.clamp(sel_idx, min=0), raw=True) * mask[..., None]
    total = raw[:, 0]
    for j in range(1, m):  # in selection order at any B (a reduction's order follows the shape)
        total = total + raw[:, j]
    sel_avg = total / torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
    return (sel_avg + text_emb.float()) * 0.5


def _full_scan(sl: Slabs, queries) -> torch.Tensor:
    """Raw queries [B, D] -> scores [B, capacity] over every slab: B2 a slab
    for int8 rows, one GEMM a slab for f32 and bf16 rows; tombstoned rows
    score NEG_INF and so do rows at or past ``size``."""
    parts = []
    with span("search.scan"):
        if sl.is_int8:
            qi, qs = quantize_queries_int8(queries.float())
            for rows, scales, pens, start in sl.per_slab():
                parts.append(stream_scores_int8(rows, qi, qs, scales, sl.size - start, pens))
        else:
            q = l2(queries.float())
            for rows, _, pens, start in sl.per_slab():
                s = float_scores(q, rows)
                if pens is not None:
                    s = s + pens[None, :]
                valid = (torch.arange(rows.shape[0], device=rows.device) + start) < sl.size
                parts.append(torch.where(valid[None, :], s, torch.full_like(s, NEG_INF)))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _search_local(sl: Slabs, queries, k: int, approx: bool = False):
    """Exact cosine top-k over the slabs; global row ids follow the slab
    concatenation order. ``approx`` takes ``lax.top_k``'s order (what the
    reference's ``approx_max_k`` returns off the TPU) instead of
    ``exact_topk``'s two-level order."""
    scores = _full_scan(sl, queries)
    with span("search.topk"):
        return lax_topk(scores, k) if approx else exact_topk(scores, k)


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _selection_matrix(rows_list, batch: int) -> np.ndarray:
    """[batch, m] global rows of each request's selection, -1 for none, m a
    power of two from 8 (the reference's padding of the two-stage paths)."""
    m = _pow2_at_least(max((len(r) for r in rows_list), default=0), 8)
    sel = np.full((batch, m), -1, np.int64)
    for b, r in enumerate(rows_list):
        sel[b, : len(r)] = r
    return sel


def _fetch(*tensors):
    """Device tensors -> numpy arrays through ONE device-to-host copy: the
    tensors' bytes are concatenated on the device and split on the host."""
    flat = [t.contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        dtype = np.dtype(str(t.dtype).removeprefix("torch."))
        out.append(raw[off : off + n].view(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _fused_twostage(text_fn, ids, sel, sl: Slabs, sk: twostage.SketchState, k, m, share):
    """The cold-query serving path (the reference's ``_fused_twostage_fn``,
    one XLA program there): token ids -> text tower -> Rocchio -> certified
    two-stage, queued on one stream with no host sync in between.
    -> (scores, ids, all(certified), raw text embeddings), on the device."""
    text = text_fn(ids).float()
    q = _rocchio_queries(sl, text, sel)
    s, i, cert = twostage.twostage_topk_block(sl, sk, q, k, m, share)
    return s, i, cert.all(), text


class VectorIndex:
    """Exact cosine top-k index resident in device memory (slab storage)."""

    # consecutive two-stage certificate failures before the sketch is dropped
    # (a flat-spectrum corpus would otherwise pay the bound pass AND the full
    # scan on every query); re-armed by build_sketch
    TWOSTAGE_DISABLE_AFTER = 8

    def __init__(
        self,
        dim: int,
        device="cuda",
        min_capacity: int = 8192,
        store=None,
        quantize: Optional[str] = None,
        slab_rows: int = DEFAULT_SLAB_ROWS,
        capacity: Optional[int] = None,
        mesh=None,
    ):
        if quantize not in QUANT_DTYPES:
            raise ValueError(f"quantize must be one of {list(QUANT_DTYPES)}")
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        self.dim = dim
        self.device = torch.device(device)
        self.store = store
        self.quantize = quantize
        self._row_dtype = QUANT_DTYPES[quantize]
        self._cap_multiple = -(-max(min_capacity, _UPDATE_BLOCK) // _UPDATE_BLOCK) * _UPDATE_BLOCK
        self._slab_rows = max(
            self._cap_multiple, -(-slab_rows // self._cap_multiple) * self._cap_multiple
        )
        self._paths: List[str] = []
        self._row: dict = {}
        self._size = 0
        # guards metadata and slab swaps; searches snapshot the slab list and
        # size under it and compute outside it
        self._lock = threading.RLock()
        self._emb_slabs: List[torch.Tensor] = []
        self._norm_slabs: List[torch.Tensor] = []
        self._scale_slabs: Optional[List[torch.Tensor]] = [] if quantize == "int8" else None
        self._pen_slabs: List[torch.Tensor] = []
        self._removed = 0
        # paths tombstoned in this process and not re-added since (was_removed)
        self._dead_paths: set = set()
        # the corpus sketch (index/twostage.py): None until build_sketch();
        # kept fresh across appends by _update_sketch_incremental
        self._sketch: Optional[twostage.SketchState] = None
        self.twostage_certified = 0
        self.twostage_fallbacks = 0
        # consecutive certificate failures; at TWOSTAGE_DISABLE_AFTER the
        # sketch is dropped until the next build
        self._twostage_consec_failures = 0
        self.sketch_incremental = 0  # appends absorbed without a rebuild
        # build-time certifiability gate (build_sketch min_certifiable): last
        # estimate (None until a gated build ran) and the count of refusals
        self.sketch_certifiable_est: Optional[float] = None
        self.twostage_gate_skips = 0
        if capacity is not None:
            self._preallocate(capacity)
        else:
            self._append_slab(self._cap_multiple)
        if store is not None and len(store):
            # dead rows (tombstoned, or superseded by a later re-append) are
            # skipped outright, as the reference does
            live_mask, _ = store.liveness()
            base, skipped = 0, 0
            for paths, emb in store.iter_shards():
                if live_mask is None:
                    self._add_in_memory(paths, emb)
                else:
                    keep = [i for i in range(len(paths)) if live_mask[base + i]]
                    skipped += len(paths) - len(keep)
                    if keep:
                        self._add_in_memory([paths[i] for i in keep], emb[keep])
                base += len(paths)
            log.info(
                "index restored from %s: %d live vectors (%d dead rows skipped)",
                store.directory, self._size, skipped,
            )
            store.release_path_cache()

    @classmethod
    def from_store(cls, store, device="cuda", quantize: Optional[str] = None, **kwargs):
        return cls(store.dim, device=device, store=store, quantize=quantize, **kwargs)

    # -- storage ------------------------------------------------------------

    def _zeros(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _append_slab(self, rows: int) -> None:
        self._emb_slabs.append(self._zeros((rows, self.dim), self._row_dtype))
        self._norm_slabs.append(self._zeros((rows,)))
        if self._scale_slabs is not None:
            self._scale_slabs.append(self._zeros((rows,)))
        self._pen_slabs.append(self._zeros((rows,)))

    def _preallocate(self, capacity: int) -> None:
        self._check_memory(max(capacity, 1))
        remaining = max(capacity, 1)
        while remaining > 0:
            rows = min(self._slab_rows, max(remaining, self._cap_multiple))
            rows = -(-rows // self._cap_multiple) * self._cap_multiple
            self._append_slab(rows)
            remaining -= rows

    def _bytes_per_row(self) -> int:
        per = self.dim * torch.tensor([], dtype=self._row_dtype).element_size() + 4 + 4
        return per + (4 if self._scale_slabs is not None else 0)

    def _check_memory(self, projected_rows: int) -> None:
        """Fail with an actionable error instead of a device OOM: slabs may
        take at most 85% of the card's memory (the towers live in the rest).
        ``ISX_INDEX_HBM_BUDGET_GB``, when set, replaces that budget on any
        device, and a value <= 0 turns it off (the reference's
        ``_check_hbm_budget``); without it the CPU is never blocked."""
        env = os.environ.get("ISX_INDEX_HBM_BUDGET_GB")
        if env is not None:
            if float(env) <= 0:
                return
            budget = int(float(env) * 1e9)
        elif self.device.type == "cuda":
            budget = int(0.85 * torch.cuda.get_device_properties(self.device).total_memory)
        else:
            return
        need = projected_rows * self._bytes_per_row()
        if need > budget:
            raise RuntimeError(
                f"index growth to {projected_rows:,} rows needs ~{need / 1e9:.1f} GB, over the "
                f"{budget / 1e9:.1f} GB budget (85% of the card's memory, or ISX_INDEX_HBM_BUDGET_GB); "
                f"use --index-quantize int8 or raise ISX_INDEX_HBM_BUDGET_GB"
            )

    @property
    def capacity(self) -> int:
        return sum(s.shape[0] for s in self._emb_slabs)

    def _ensure_capacity(self, n: int) -> None:
        while self.capacity < n:
            last = self._emb_slabs[-1].shape[0]
            if last < self._slab_rows:
                # the FIRST slab doubles up to slab_rows; old + new are both
                # at most one slab
                new_rows = min(self._slab_rows, last * 2)
                self._check_memory(self.capacity + new_rows)

                def grow(old, shape):
                    new = self._zeros(shape, old.dtype)
                    new[: old.shape[0]] = old
                    return new

                self._emb_slabs[-1] = grow(self._emb_slabs[-1], (new_rows, self.dim))
                self._norm_slabs[-1] = grow(self._norm_slabs[-1], (new_rows,))
                if self._scale_slabs is not None:
                    self._scale_slabs[-1] = grow(self._scale_slabs[-1], (new_rows,))
                self._pen_slabs[-1] = grow(self._pen_slabs[-1], (new_rows,))
            else:
                self._check_memory(self.capacity + self._slab_rows)
                self._append_slab(self._slab_rows)

    def _locate(self, gpos: int) -> Tuple[int, int]:
        """Global row position -> (slab index, slab-local offset)."""
        start = 0
        for i, slab in enumerate(self._emb_slabs):
            n = slab.shape[0]
            if gpos < start + n:
                return i, gpos - start
            start += n
        raise IndexError(gpos)

    # -- mutation -------------------------------------------------------------

    def __len__(self) -> int:
        """Number of LIVE (searchable) rows."""
        return self._size - self._removed

    @property
    def removed_count(self) -> int:
        return self._removed

    def live_paths(self) -> List[str]:
        """Snapshot of the searchable paths (tombstoned ones excluded)."""
        with self._lock:
            return list(self._row)

    @property
    def paths(self) -> List[str]:
        return self._paths

    def _add_in_memory(self, paths: Sequence[str], embeddings: np.ndarray) -> int:
        with self._lock:
            embeddings = np.require(embeddings, np.float32, "CW")
            # dedup against the index AND within the batch (first one wins)
            seen: set = set()
            keep = []
            for i, p in enumerate(paths):
                if p in self._row or p in seen:
                    continue
                seen.add(p)
                keep.append(i)
            if not keep:
                return 0
            if len(keep) < len(paths):
                paths = [paths[i] for i in keep]
                embeddings = embeddings[keep]
            n = len(paths)
            self._ensure_capacity(self._size + n)
            with span("index.append"):
                off = 0
                while off < n:  # a chunk of raw rows to the device, one write within a slab
                    i, local = self._locate(self._size + off)
                    m = min(self._emb_slabs[i].shape[0] - local, _APPEND_ROWS, n - off)
                    sl = slice(local, local + m)
                    normalize_rows_into(
                        torch.from_numpy(embeddings[off : off + m]).to(self.device),
                        self._emb_slabs[i][sl], self._norm_slabs[i][sl],
                        None if self._scale_slabs is None else self._scale_slabs[i][sl],
                    )
                    off += m
            for j, p in enumerate(paths):
                self._row[p] = self._size + j
                self._dead_paths.discard(p)  # re-added after a tombstone: live again
            self._paths.extend(paths)
            self._size += n
            return n

    def add(self, paths: Sequence[str], embeddings: np.ndarray) -> int:
        """Insert raw (unnormalized) embeddings; dedups by path; persists to
        the attached store if any. Returns #rows actually added."""
        with self._lock:
            prev_sketch = self._sketch
            added = self._add_in_memory(paths, embeddings)
            if added and self.store is not None:
                self.store.append(list(paths), np.asarray(embeddings, np.float32))
            if added and prev_sketch is not None:
                # a stale sketch would under-bound the new rows, so sketch
                # them now against the existing basis (the bound is per row:
                # still rigorous) or invalidate
                try:
                    ok = self._update_sketch_incremental(prev_sketch)
                except Exception:  # never trade ingest for sketch upkeep
                    log.exception("incremental sketch update failed; invalidating")
                    ok = False
                if ok:
                    self.sketch_incremental += 1
                else:
                    self._sketch = None
            return added

    def _update_sketch_incremental(self, sk) -> bool:
        """Sketch rows [sk.built_rows, self._size) with the EXISTING basis and
        write them into the sketch slabs. Caller holds ``self._lock``.

        The slab sketches are updated in place: rows below the old
        ``built_rows`` get the values they had (same rows, same basis, up to
        f32 rounding), and rows at or past it are masked out by a scan that
        still holds the old state, so such a scan reads valid bounds either
        way. A tail slab that doubled under this append (``_ensure_capacity``
        copies the old rows to offset 0) gets a zero-padded sketch slab."""
        d_s = sk.basis.shape[1]
        sdtype = sk.sketches[0].dtype
        to_bf16 = sdtype == torch.bfloat16
        # re-sketch from the aligned block boundary; rows past self._size are
        # zeros (sketch 0, tiny resid) that the scans mask by size
        lo = (sk.built_rows // _UPDATE_BLOCK) * _UPDATE_BLOCK
        hi = self._size
        sketches, resid = list(sk.sketches), list(sk.resid)
        slack = sk.ub_slack
        while len(sketches) < len(self._emb_slabs):  # newly allocated slabs
            n_i = self._emb_slabs[len(sketches)].shape[0]
            sketches.append(self._zeros((n_i, d_s), sdtype))
            resid.append(self._zeros((n_i,)))
        for i, (slab, scale, _, start) in enumerate(self._snapshot().per_slab()):
            n_i = slab.shape[0]
            pad = n_i - sketches[i].shape[0]
            if pad < 0:
                return False
            if pad:
                sketches[i] = torch.cat([sketches[i], self._zeros((pad, d_s), sdtype)])
                resid[i] = torch.cat([resid[i], self._zeros((pad,))])
            s_lo, s_hi = max(lo, start), min(hi, start + n_i)
            if s_lo < s_hi:
                l0 = ((s_lo - start) // _UPDATE_BLOCK) * _UPDATE_BLOCK
                l1 = min(n_i, -(-(s_hi - start) // _UPDATE_BLOCK) * _UPDATE_BLOCK)
                sc = None if scale is None else scale[l0:l1]
                s, t, d = twostage.sketch_slab(slab[l0:l1], sc, sk.basis, to_bf16)
                sketches[i][l0:l1] = s
                resid[i][l0:l1] = t
                slack = torch.maximum(slack, d)
        self._sketch = twostage.SketchState(
            sk.basis, tuple(sketches), tuple(resid), self._size, slack
        )
        return True

    def _remove_in_memory(self, paths: Sequence[str]):
        with self._lock:
            rows, removed = [], []
            for p in paths:
                r = self._row.pop(p, None)
                if r is not None:
                    rows.append(r)
                    removed.append(p)
            if not rows:
                return 0, []
            self._dead_paths.update(removed)
            by_slab: dict = {}
            for g in rows:
                i, local = self._locate(g)
                by_slab.setdefault(i, []).append(local)
            for i, locs in by_slab.items():
                self._pen_slabs[i][torch.tensor(locs, device=self.device)] = NEG_INF
            self._removed += len(rows)
            return len(rows), removed

    def remove_paths(self, paths: Sequence[str], exclude: bool = False) -> int:
        """Tombstone rows by path: masked, not compacted, so global ids stay
        stable; with a store attached they stay removed across restarts, and
        re-adding a path later inserts a fresh live row. ``exclude=True`` (an
        explicit deletion by the user) also marks the paths excluded in the
        store, so rescans skip them while their files exist; a plain removal
        (a prune of vanished files) stays re-addable by a rescan. Returns the
        number of rows removed."""
        n, _ = self.remove_paths_report(paths, exclude=exclude)
        return n

    def remove_paths_report(self, paths: Sequence[str], exclude: bool = False) -> Tuple[int, List[str]]:
        """:meth:`remove_paths`, also returning the paths whose rows were
        tombstoned (request duplicates and unknown paths left out)."""
        with self._lock:
            n, removed = self._remove_in_memory(paths)
            if removed and self.store is not None:
                self.store.tombstone(removed, exclude=exclude)
            return n, removed

    # -- queries ---------------------------------------------------------------

    def _clamp_k(self, k: int) -> int:
        return max(1, min(k, self._size if self._size else 1))

    def _snapshot(self) -> Slabs:
        """Caller holds the lock: the slabs and the size, for lock-free
        compute."""
        return Slabs(
            rows=tuple(self._emb_slabs),
            norms=tuple(self._norm_slabs),
            scales=None if self._scale_slabs is None else tuple(self._scale_slabs),
            pens=tuple(self._pen_slabs) if self._removed else None,
            size=self._size,
        )

    def _as_queries(self, x, rows: int) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device).reshape(rows, self.dim)

    @staticmethod
    def _to_host(s, i):
        with span("search.to_host"):  # the search's one wait for the device
            return s.cpu().numpy(), i.cpu().numpy().astype(np.int32)

    def search(self, queries, k: int = 1000, approx: bool = False):
        """Raw query vectors [B, D] or [D] (numpy or tensor) -> (scores [B, k],
        row indices [B, k]). ``approx``: ``lax.top_k``'s order (module doc)."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        q = self._as_queries(q, q.numel() // self.dim)
        with self._lock:
            if self._size == 0:
                B = q.shape[0]
                return np.zeros((B, 0), np.float32), np.zeros((B, 0), np.int32)
            k = self._clamp_k(k)
            sl = self._snapshot()
        return self._to_host(*_search_local(sl, q, k, approx))

    def search_with_feedback(self, text_embedding, selected_paths: Sequence[str], k: int = 1000,
                             approx: bool = False):
        """The reference's refinement search (search.rs:34-77). Unknown paths
        are skipped; with no known selection this is the plain text search."""
        with self._lock:
            known = any(p in self._row for p in selected_paths)
        if not known:
            return self.search(text_embedding, k, approx)
        return self.search_with_feedback_batch(
            self._as_queries(text_embedding, 1), [list(selected_paths)], k, approx
        )

    def search_with_feedback_batch(self, text_embeddings, selected_paths_list, k: int = 1000,
                                   approx: bool = False):
        """B Rocchio searches in one pass. ``text_embeddings`` is [B, D] raw
        text vectors (numpy or device tensor); each selection list holds
        absolute paths, possibly empty (then that row is the plain search,
        bitwise)."""
        B = len(selected_paths_list)
        text = self._as_queries(text_embeddings, B)
        with self._lock:
            if self._size == 0:
                return np.zeros((B, 0), np.float32), np.zeros((B, 0), np.int32)
            k = self._clamp_k(k)
            rows_list = [[self._row[p] for p in sel if p in self._row] for sel in selected_paths_list]
            sl = self._snapshot()
        m = max(1, max(len(r) for r in rows_list))
        sel = np.full((B, m), -1, np.int64)
        for b, r in enumerate(rows_list):
            sel[b, : len(r)] = r
        with span("search.rocchio"):
            q = _rocchio_queries(sl, text, torch.from_numpy(sel).to(self.device))
        return self._to_host(*_search_local(sl, q, k, approx))

    # -- the corpus sketch (index/twostage.py) ----------------------------------

    def build_sketch(
        self, d_s: int = 64, sample_rows: int = 8192, dtype: str = "float32",
        min_certifiable: float = 0.0, est_k: int = 1000,
    ) -> None:
        """Build the corpus sketch: one streaming pass over the slabs plus a
        host SVD of a strided row sample. No-op on an empty index.

        ``dtype="bfloat16"`` stores the sketch in bf16 (its rounding is
        folded into a data-derived bound inflation, ``ub_slack``).
        ``min_certifiable`` > 0 gates publication on the build-time
        certifiability estimate (``twostage.estimate_certifiable_fraction``
        with ``est_k``-fraction-scaled ranks): a spectrally flat corpus then
        gets no sketch, and the duplicate scan takes another route. The
        estimate lands in ``sketch_certifiable_est`` either way."""
        to_bf16 = dtype in ("bfloat16", "bf16")
        with self._lock:
            if self._size == 0:
                return
            sl = self._snapshot()
        size = sl.size
        m = min(sample_rows, size)
        idx = torch.from_numpy(np.linspace(0, size - 1, m).astype(np.int64)).to(self.device)
        sample = dequantized(sl, idx).cpu().numpy()
        basis_np = twostage.fit_basis(sample, d_s)
        if min_certifiable > 0.0:
            est = twostage.estimate_certifiable_fraction(
                sample, basis_np, size, k=est_k,
                candidate_rows=twostage.DEFAULT_BLOCKS * twostage.BLOCK,
                fs_slack=twostage.FULL_SCAN_SLACK[sl.dtype_name],
                # bf16 sketch storage costs a data-derived ub_slack that is
                # not known yet: charge the 0.01 the reference charges
                ub_slack=0.01 if to_bf16 else 0.0,
            )
            self.sketch_certifiable_est = est
            if est < min_certifiable:
                log.warning(
                    "sketch NOT published: estimated certifiable fraction %.2f < %.2f "
                    "gate (corpus spectrum too flat)", est, min_certifiable,
                )
                with self._lock:
                    self._sketch = None
                    self.twostage_gate_skips += 1
                return
        basis = torch.from_numpy(basis_np).to(self.device)
        sketches, resid = [], []
        slack = torch.zeros((), dtype=torch.float32, device=self.device)
        for rows, scales, _, _ in sl.per_slab():
            s, t, d = twostage.sketch_slab(rows, scales, basis, to_bf16)
            sketches.append(s)
            resid.append(t)
            slack = torch.maximum(slack, d)
        with self._lock:
            if self._size != size:
                return  # a concurrent append won the race; this sketch is stale
            self._sketch = twostage.SketchState(basis, tuple(sketches), tuple(resid), size, slack)
            self._twostage_consec_failures = 0  # re-arm the adaptive disable

    @property
    def sketch_fresh(self) -> bool:
        return self._sketch is not None and self._sketch.built_rows == self._size

    def drop_sketch(self) -> None:
        """Unpublish the sketch (the engine does so after building an UNGATED
        sketch solely for the approximate duplicate scan)."""
        with self._lock:
            self._sketch = None

    # -- the certified two-stage search (index/twostage.py) ----------------------

    def _twostage_snapshot(self, k, candidates, selected_paths_list=None):
        """One lock acquisition for everything the two-stage path needs:
        ``(slabs, sketch, k, c, rows_list)``, or None whenever the fast path
        cannot serve (empty index, stale or dropped sketch, or k so large
        that c candidates cannot hold it)."""
        with self._lock:
            sk = self._sketch
            if self._size == 0 or sk is None or sk.built_rows != self._size:
                return None
            k = self._clamp_k(k)
            rows_list = None
            if selected_paths_list is not None:
                rows_list = [[self._row[p] for p in sel if p in self._row] for sel in selected_paths_list]
            sl = self._snapshot()
            c = min(max(candidates, k), sl.capacity - 1)
            if c < k:
                return None
            return sl, sk, k, c, rows_list

    @staticmethod
    def _block_budget(sk, c: int, share: int, nb: int) -> int:
        """Blocks to rescore: at least c, and a per-query floor for each of
        the ``share`` distinct queries (f32 sketches c/4, bf16 sketches,
        whose ub_slack eats into the margin, c/2: the reference's measured
        floors), at most every block but one."""
        per_q = c // 2 if sk.sketches[0].dtype == torch.bfloat16 else c // 4
        return min(max(c, per_q * share), nb - 1)

    def _twostage_run(self, sl: Slabs, sk, q, k, c, fallback, count_failures, n_real: int = 0):
        """Run the bound + rescore and keep the certificate's books.
        ``fallback`` answers when the certificate fails; ``count_failures=
        False`` keeps by-construction failures out of the adaptive disable.
        ``n_real`` counts the DISTINCT queries of a batch padded by repeating
        a row (0: all), rounded up to a power of two: the union budget is
        split over real queries, not pad copies."""
        n_q = int(q.shape[0])
        share = n_q if n_real <= 0 else min(n_real, n_q)
        if share > 1:
            share = 1 << (share - 1).bit_length()
        if os.environ.get("ISX_TWOSTAGE_ROWS"):
            # row candidates (the reference's A/B switch): an exact top-c
            # selection over every bound
            s, i, cert = twostage.twostage_topk(sl, sk, q, k, c)
        else:
            nb = sl.capacity // twostage.BLOCK
            m = self._block_budget(sk, c, share, nb)
            if m < 1 or m * twostage.BLOCK < k or (share > 1 and (m // share) * twostage.BLOCK < k):
                # too small for block granularity to leave both a block not
                # chosen and k rows to rescore (batched: each query is sure
                # of only its m // share share): the full scan is as cheap
                self.twostage_fallbacks += 1
                return fallback()
            s, i, cert = twostage.twostage_topk_block(sl, sk, q, k, m, share)
        s, i, ok = _fetch(s, i, cert.all())
        if ok:
            self.twostage_certified += 1
            self._twostage_consec_failures = 0
            return s, i.astype(np.int32)
        self._note_failure(count_failures)
        return fallback()

    def _note_failure(self, count_failures: bool) -> None:
        if count_failures:
            self._note_twostage_failure()
        else:
            self.twostage_fallbacks += 1

    def search_twostage(self, queries, k: int = 1000, candidates: int = twostage.DEFAULT_CANDIDATES,
                        count_failures: bool = True):
        """Certified exact top-k: the sketch-bound pass and an exact rescore,
        falling back to the full scan whenever the certificate fails or the
        sketch is stale or absent, so the answer is always ``search``'s.

        Adaptive disable: after ``TWOSTAGE_DISABLE_AFTER`` consecutive
        certificate failures the sketch is dropped (a flat corpus fails on
        every query and would pay both passes); ``build_sketch`` re-arms it.
        ``count_failures=False`` exempts a call from that count."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        q = self._as_queries(q, q.numel() // self.dim)
        snap = self._twostage_snapshot(k, candidates)
        if snap is None:
            self.twostage_fallbacks += 1
            return self.search(q, k)
        sl, sk, k2, c, _ = snap
        return self._twostage_run(sl, sk, q, k2, c, lambda: self.search(q, k), count_failures)

    def _note_twostage_failure(self) -> None:
        self.twostage_fallbacks += 1
        self._twostage_consec_failures += 1
        if self._twostage_consec_failures >= self.TWOSTAGE_DISABLE_AFTER:
            log.warning(
                "two-stage certificate failed %d consecutive times (corpus spectrum too flat); "
                "disabling the sketch until the next rebuild", self._twostage_consec_failures,
            )
            with self._lock:
                self._sketch = None

    def search_twostage_feedback_batch(self, text_embeddings, selected_paths_list, k: int = 1000,
                                       candidates: int = twostage.DEFAULT_CANDIDATES,
                                       count_failures: bool = True):
        """The certified two-stage counterpart of ``search_with_feedback_batch``:
        the Rocchio query is one more query vector. The batch is padded to a
        power of two from 8 by REPEATING query 0 with no selection (a zero
        row would fail the certificate by construction), as the reference
        pads it. Falls back to the full-scan feedback batch when the sketch
        is absent or stale or the certificate fails."""
        B = len(selected_paths_list)
        text = self._as_queries(text_embeddings, B)
        snap = self._twostage_snapshot(k, candidates, selected_paths_list)
        if snap is None:
            self.twostage_fallbacks += 1
            return self.search_with_feedback_batch(text, selected_paths_list, k)
        sl, sk, k2, c, rows_list = snap
        bpad = _pow2_at_least(B, 8)
        sel = torch.from_numpy(_selection_matrix(rows_list, bpad)).to(self.device)
        text_p = torch.cat([text, text[:1].expand(bpad - B, self.dim)]) if bpad > B else text
        q = _rocchio_queries(sl, text_p, sel)
        got = self._twostage_run(sl, sk, q, k2, c, lambda: None, count_failures, n_real=B)
        if got is None:  # the certificate failed: the full-scan feedback batch
            return self.search_with_feedback_batch(text, selected_paths_list, k)
        return got[0][:B], got[1][:B]

    def search_twostage_fused_tokens(self, text_fn, ids, selected_paths_list, k: int = 1000,
                                     candidates: int = twostage.DEFAULT_CANDIDATES,
                                     count_failures: bool = True):
        """The whole cold-query path: token ids [Bpad, L] (numpy) -> the text
        tower ``text_fn(ids_tensor) -> [Bpad, D]`` -> Rocchio -> certified
        two-stage, queued without a host sync, and ONE device-to-host copy
        for the certificate, scores, ids and text embeddings together.
        ``ids`` is padded to a power of two (from 1) by REPEATING row 0.

        -> ``(scores[:B], ids[:B], text[:B])`` when certified;
        ``(None, None, text[:B])`` when the certificate failed (the caller
        runs the full scan on those embeddings); ``(None, None, None)`` when
        this path cannot serve (no or stale sketch, corpus too small for
        block granularity)."""
        B = len(selected_paths_list)
        snap = self._twostage_snapshot(k, candidates, selected_paths_list)
        if snap is None:
            return None, None, None
        sl, sk, k2, c, rows_list = snap
        bpad = int(ids.shape[0])
        share = 1 << (B - 1).bit_length() if B > 1 else 1
        nb = sl.capacity // twostage.BLOCK
        m = self._block_budget(sk, c, share, nb)
        # true division here, as the reference's fused guard has it
        if m < 1 or m * twostage.BLOCK < k2 or (share > 1 and (m / share) * twostage.BLOCK < k2):
            self.twostage_fallbacks += 1
            return None, None, None
        sel = torch.from_numpy(_selection_matrix(rows_list, bpad)).to(self.device)
        ids_dev = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        s, i, cert, text = _fused_twostage(text_fn, ids_dev, sel, sl, sk, k2, m, share)
        ok, s_np, i_np, text_np = _fetch(cert, s[:B], i[:B], text[:B])
        if ok:
            self.twostage_certified += 1
            self._twostage_consec_failures = 0
            return s_np, i_np.astype(np.int32), text_np
        self._note_failure(count_failures)
        return None, None, text_np

    # -- duplicate scans -----------------------------------------------------------

    def find_near_duplicates(
        self,
        threshold: float = 0.95,
        neighbors: int = 8,
        batch: int = 1024,
        approx: bool = False,
        progress=None,
    ):
        """Near-duplicate pairs by cosine similarity, the legacy scan: every
        live row is queried against the index in batches of ``batch`` (the
        last one padded with its final row, as the reference pads it), and
        neighbour pairs scoring >= threshold come back as (row_i, row_j,
        score), i < j, each once. ``progress(rows_done, rows_total)`` is
        called after every batch. ``approx`` takes ``lax.top_k``'s order, as
        :meth:`search` does."""
        with self._lock:
            rows = sorted(self._row.values())
            if not rows:
                return []
            sl = self._snapshot()
        k = min(neighbors + 1, sl.size)  # +1: the self-match is always there
        pair_chunks: List[np.ndarray] = []
        score_chunks: List[np.ndarray] = []
        total = len(rows)
        for lo in range(0, total, batch):
            chunk = rows[lo : lo + batch]
            idx = np.full((batch,), chunk[-1], np.int64)
            idx[: len(chunk)] = chunk
            q = dequantized(sl, torch.from_numpy(idx).to(self.device))
            sc, nb = _search_local(sl, q, k, approx)
            sc = sc[: len(chunk)].cpu().numpy()
            nb = nb[: len(chunk)].cpu().numpy().astype(np.int64)
            r = np.asarray(chunk, np.int64)[:, None]
            # both orientations, normalized to (min, max): in a cluster larger
            # than `neighbors`, top-k tie-breaking can make high-id members
            # visible only from their own query side
            mask = (nb != r) & (sc >= threshold)
            if mask.any():
                ri = np.broadcast_to(r, nb.shape)[mask]
                rj = nb[mask]
                pair_chunks.append(np.stack([np.minimum(ri, rj), np.maximum(ri, rj)], axis=1))
                score_chunks.append(sc[mask].astype(np.float32))
            if progress is not None:
                progress(min(lo + batch, total), total)
        if not pair_chunks:
            return []
        pairs = np.concatenate(pair_chunks)
        scores = np.concatenate(score_chunks)
        # dedupe keeping the max score per (i, j)
        order = np.lexsort((-scores, pairs[:, 1], pairs[:, 0]))
        pairs, scores = pairs[order], scores[order]
        first = np.ones(len(pairs), bool)
        first[1:] = (pairs[1:] != pairs[:-1]).any(axis=1)
        pairs, scores = pairs[first], scores[first]
        return [(int(i), int(j), float(s)) for (i, j), s in zip(pairs, scores)]

    def _sketch_scan_snapshot(self):
        """-> (slabs, sketch) for the sketch scans; raises
        ``dupscan.DupScanBailout`` without a fresh sketch."""
        with self._lock:
            sk = self._sketch
            if sk is None or sk.built_rows != self._size:
                raise dupscan.DupScanBailout("no fresh sketch")
            return self._snapshot(), sk

    def find_near_duplicates_sketch(self, threshold: float = 0.95, progress=None, **kw):
        """The certified sketch scan (``dupscan.sketch_duplicate_pairs``):
        every live pair with cosine >= threshold, not truncated to a
        neighbour count. Raises ``dupscan.DupScanBailout`` without a fresh
        sketch or when the corpus is too flat for the bound to prune."""
        sl, sk = self._sketch_scan_snapshot()
        return dupscan.sketch_duplicate_pairs(sl, sk, threshold, progress=progress, **kw)

    def find_near_duplicates_candidates(self, threshold: float = 0.95, progress=None, **kw):
        """The approximate sketch-candidate scan
        (``dupscan.sketch_candidate_pairs``): emitted pairs carry true f32
        scores >= threshold; recall is heuristic. Needs a fresh sketch."""
        sl, sk = self._sketch_scan_snapshot()
        return dupscan.sketch_candidate_pairs(sl, sk, threshold, progress=progress, **kw)

    # -- lookups ---------------------------------------------------------------

    def has_path(self, path: str) -> bool:
        return path in self._row

    def was_removed(self, path: str) -> bool:
        """Whether ``path``'s row was tombstoned in this process and not
        re-added since: lets the engine honour an explicit removal of a path
        already pruned while its file is absent (the store's tombstone log
        covers a restart)."""
        return path in self._dead_paths

    def get_raw_embeddings(self, paths: Sequence[str]) -> np.ndarray:
        """Stored raw vectors for the given paths (the search.rs:43-58 SELECT)."""
        with self._lock:
            rows = [self._row[p] for p in paths if p in self._row]
            if not rows:
                return np.zeros((0, self.dim), np.float32)
            sl = self._snapshot()
        return dequantized(sl, torch.tensor(rows, device=self.device), raw=True).cpu().numpy()
