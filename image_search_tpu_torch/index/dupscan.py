"""Sketch-accelerated near-duplicate scan: all pairs >= threshold.

Port of ``image_search_tpu/index/dupscan.py``. The legacy scan
(``VectorIndex.find_near_duplicates``) self-queries every row, O(N) searches
of O(N) rows each. This scan replaces the N^2 full-dimension sweep with the
sketch's pair bound (``index/twostage.py``):

  phase 1 — block prune (``ops/blockmax.py``, kernels B3 and B4): every row's
    sketch is AUGMENTED with its residual norm as one more coordinate,
    a_i = [s_i, t_i], so the per-pair bound r_i.r_j <= s_i.s_j + t_i*t_j is
    one dot a_i.a_j. For every pair of 128-row blocks the kernel takes the
    maximum of that product and thresholds it at (threshold - pair_slack):
    cleared block pairs PROVABLY contain no qualifying pair.

  phase 2 — exact rescore: surviving block pairs (always including the
    diagonal blocks — a block's self-bound is ~1) are gathered from the
    slabs and rescored with a full-f32 dot; pairs scoring >= threshold are
    emitted as (i, j, score), i < j, each once.

Guarantee: with rows r (the dequantized stored vectors the legacy scan also
scores), every pair with true dot >= threshold + ~2e-4 is emitted and none
below threshold - ~2e-4. Unlike the legacy scan the output is the complete
pair set, not truncated to a per-row neighbour count.

Worst case: on spectrally flat corpora residual products alone exceed the
threshold, nothing prunes, and ``DupScanBailout`` fires once surviving block
pairs exceed ``max_rescore_frac`` of all block pairs; the caller then takes
the approximate scan (:func:`sketch_candidate_pairs`) or the legacy one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from image_search_tpu_torch.index.slabs import Slabs, dequantized, gather
from image_search_tpu_torch.index.twostage import SketchState, slack_for_dim
from image_search_tpu_torch.ops.blockmax import (
    BLOCK,
    COLS_TILE,
    COLS_TILE_V,
    ROWS_TILE,
    blockpair_mask,
    blockpair_values,
    kernel_depth,
)
from image_search_tpu_torch.ops.topk import exact_topk

# rows per phase-1 kernel call: each call re-reads the whole sketch array on
# its column side. Must be a multiple of both ROWS_TILE and COLS_TILE.
ROWS_PER_CALL = 262_144
assert ROWS_PER_CALL % ROWS_TILE == 0 and ROWS_PER_CALL % COLS_TILE == 0


class DupScanBailout(RuntimeError):
    """Sketch bound prunes too little on this corpus — use another scan."""


def _prep_slab(sl: Slabs, sk: SketchState, i: int):
    """Augment slab i's sketches with their residual norms (so the kernel's
    dot IS the per-pair bound) and zero the rows that must never produce a
    pair: tombstoned (pen == NEG_INF) and beyond the live size. Returns
    (bf16 augmented sketch [n, d_s+1], max ||a - bf16(a)|| over kept rows, a
    0-dim tensor)."""
    sketch = sk.sketches[i]
    live = (torch.arange(sketch.shape[0], device=sketch.device) + sl.starts[i]) < sl.size
    if sl.pens is not None:
        live = live & (sl.pens[i] >= 0.0)
    a32 = torch.cat([sketch.float(), sk.resid[i].float()[:, None]], dim=1)
    a32 = torch.where(live[:, None], a32, torch.zeros((), device=a32.device))
    a16 = a32.to(torch.bfloat16)
    delta = torch.sqrt(((a32 - a16.float()) ** 2).sum(dim=1))
    return a16, delta.max()


def _pair_slack(max_delta: float, dim: int) -> float:
    """Additive UB inflation covering both operands' bf16 rounding plus
    f32 accumulation error: |a_i.a_j - bf16dot(a~_i, a~_j)| <=
    delta_i ||a_j|| + delta_j ||a~_i|| <= 2 * 1.01 * max_delta (augmented
    norms = sqrt(||s||^2 + t^2) = ||r|| <= 1 + 2^-8), and gamma_65
    accumulation and the sketches' own D-long reductions within
    ``twostage.slack_for_dim(dim)`` (the reference's SLACK at D <= 768)."""
    return 2.0 * 1.01 * float(max_delta) + slack_for_dim(dim)


def _decode_words(words: np.ndarray, row_block0: int):
    """Packed int32 [rb, W] -> (bi, bj) int64 arrays (bit layout:
    ops/blockmax.py module docstring)."""
    rloc, wc = np.nonzero(words)
    if len(rloc) == 0:
        return (np.empty(0, np.int64),) * 2
    w = words[rloc, wc].astype(np.uint32)[:, None]
    bits = (w >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    sel = bits.astype(bool)
    bi = np.broadcast_to((rloc + row_block0)[:, None], sel.shape)[sel]
    bj = (wc[:, None] * 32 + np.arange(32)[None, :])[sel]
    return bi.astype(np.int64), bj.astype(np.int64)


def _to_host_async(t: torch.Tensor):
    """Start copying ``t`` to the host; -> (host tensor, event to wait on, or
    None on the CPU). The copy is queued behind the kernel that makes ``t``,
    so the host can queue the next call before it waits for this one."""
    if t.device.type != "cuda":
        return t, None
    host = t.to("cpu", non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _from_host(entry) -> np.ndarray:
    host, ev = entry
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _rescore_chunk(sl: Slabs, bi, bj, threshold: float):
    """PB block pairs -> (flat indices into [PB, 128, 128], scores) of the row
    pairs with i < j, both live, whose full-f32 dot is >= threshold."""
    ar = torch.arange(BLOCK, device=bi.device)[None, :]
    gi = bi[:, None] * BLOCK + ar            # [PB, 128] global row ids
    gj = bj[:, None] * BLOCK + ar
    # full f32 (no TF32): the emitted score must match the true f32 dot to
    # ~1e-5 so that the guarantee band stays ~2e-4
    sc = torch.bmm(dequantized(sl, gi), dequantized(sl, gj).transpose(1, 2))
    vi = gi < sl.size
    vj = gj < sl.size
    if sl.pens is not None:
        vi = vi & (gather(gi, sl.pens)[0] >= 0)
        vj = vj & (gather(gj, sl.pens)[0] >= 0)
    keep = (
        vi[:, :, None]
        & vj[:, None, :]
        & (gi[:, :, None] < gj[:, None, :])  # i < j once, kills self-pairs
        & (sc >= threshold)
    )
    idx = torch.nonzero(keep.reshape(-1)).reshape(-1)
    return idx, sc.reshape(-1)[idx]


def sketch_duplicate_pairs(
    sl: Slabs,
    sketch: SketchState,
    threshold: float,
    *,
    progress: Optional[Callable[[int, int], None]] = None,
    rows_per_call: int = ROWS_PER_CALL,
    # the rescore gather makes a [chunk*128, D] f32 temporary per slab per side
    chunk_pairs: int = 256,
    max_rescore_frac: float = 0.01,
) -> List[Tuple[int, int, float]]:
    """Complete (i, j, score) pair list with score >= threshold, i < j.

    ``sketch`` must cover exactly the live corpus (``built_rows ==
    sl.size``); the index wrapper enforces that. Raises
    :class:`DupScanBailout` when the bound prunes too little (flat
    corpus)."""
    s_all, n_pad, slack, nb_real, rows_per_call = _prep_sketch(sl, sketch, rows_per_call)
    # padded/zeroed rows rely on their UB of 0 falling below the compare
    # point — thresholds at or under the slack (~0.013) are not duplicate
    # territory anyway, so refuse rather than emit garbage
    if threshold - slack <= 0.0:
        raise DupScanBailout(
            f"threshold {threshold} <= pair slack {slack:.4f}; use the legacy scan"
        )
    n_calls = n_pad // rows_per_call
    total_block_pairs = nb_real * (nb_real + 1) // 2
    budget = max(int(max_rescore_frac * total_block_pairs), 4 * nb_real)

    def _prog(frac: float) -> None:
        if progress is not None:
            progress(int(frac * 1000), 1000)

    # ---- phase 1: block-pair sweep, two-deep dispatch pipeline ---------
    pend: list = []
    all_bi: List[np.ndarray] = []
    all_bj: List[np.ndarray] = []
    survivors = 0

    def _drain(entry):
        nonlocal survivors
        r0, fut = entry
        bi, bj = _decode_words(_from_host(fut), r0 // BLOCK)
        # padded col blocks carry zero sketches (never set); row blocks
        # past nb_real likewise — no masking needed beyond the decode
        all_bi.append(bi)
        all_bj.append(bj)
        survivors += len(bi)
        if survivors > budget:
            raise DupScanBailout(
                f"{survivors} surviving block pairs > budget {budget} "
                f"(max_rescore_frac={max_rescore_frac}); corpus too flat "
                f"for the sketch bound at threshold {threshold}"
            )

    for ci, r0 in enumerate(range(0, n_pad, rows_per_call)):
        words = blockpair_mask(
            s_all[r0 : r0 + rows_per_call], s_all, threshold - slack, r0 // BLOCK
        )
        pend.append((r0, _to_host_async(words)))
        if len(pend) >= 2:
            _drain(pend.pop(0))
        _prog(0.45 * (ci + 1) / n_calls)
    while pend:
        _drain(pend.pop(0))
    _prog(0.5)

    del s_all  # phase 2 needs the memory
    bi = np.concatenate(all_bi) if all_bi else np.empty(0, np.int64)
    bj = np.concatenate(all_bj) if all_bj else np.empty(0, np.int64)
    if len(bi) == 0:
        _prog(1.0)
        return []
    # gather locality: rescore chunks touch contiguous slab ranges
    order = np.lexsort((bj, bi))
    bi, bj = bi[order], bj[order]

    # ---- phase 2: exact rescore of survivors ---------------------------
    out = _rescore_pairs(sl, bi, bj, threshold, chunk_pairs, _prog)
    _prog(1.0)
    return out


def _prep_sketch(sl: Slabs, sketch: SketchState, rows_per_call: int, granule: int = COLS_TILE):
    """Shared phase 0 of both scans: augment and zero every slab's sketches
    (_prep_slab), concatenate, pad to a rows_per_call multiple and the depth
    to the kernels' k step (``kernel_depth``: d_s + 1 = 65 -> 80, zero
    columns, so the sweep copies nothing). ``granule`` is the kernel's column
    granule (COLS_TILE for the mask, COLS_TILE_V for the values). Returns
    (s_all [n_pad, kernel_depth(d_s+1)] bf16, n_pad, pair slack, nb_real,
    adjusted rows_per_call)."""
    assert rows_per_call % ROWS_TILE == 0 and rows_per_call % granule == 0
    # small corpora: shrink the call so padding stays proportional to the data
    cap = sl.capacity
    rows_per_call = min(rows_per_call, -(-cap // granule) * granule)
    parts_s, deltas = zip(*(_prep_slab(sl, sketch, i) for i in range(len(sketch.sketches))))
    # stored-bf16 sketches: _prep_slab's delta only sees the f32 view of
    # the stored values; the original quantization error is bounded by the
    # state's recorded ub_slack (>= max storage delta by construction)
    max_delta = max(float(torch.stack(deltas).max()), 0.0)
    if sketch.sketches[0].dtype == torch.bfloat16 and sketch.ub_slack is not None:
        max_delta += float(sketch.ub_slack)
    slack = _pair_slack(max_delta, sketch.basis.shape[0])
    n_pad = -(-cap // rows_per_call) * rows_per_call
    s_all = torch.cat(parts_s) if len(parts_s) > 1 else parts_s[0]
    del parts_s
    da = s_all.shape[1]
    if n_pad != cap or kernel_depth(da) != da:
        s_all = torch.nn.functional.pad(s_all, (0, kernel_depth(da) - da, 0, n_pad - cap))
    nb_real = -(-sl.size // BLOCK)
    return s_all.contiguous(), n_pad, slack, nb_real, rows_per_call


def sketch_candidate_pairs(
    sl: Slabs,
    sketch: SketchState,
    threshold: float,
    *,
    progress: Optional[Callable[[int, int], None]] = None,
    # 65536 rows per call caps the values output at [512, N/128] f32 — 160 MB
    # at 10M rows; more calls only re-read the 130 B/row sketch array
    rows_per_call: int = 65_536,
    chunk_pairs: int = 256,
    cands_per_block: int = 8,
) -> List[Tuple[int, int, float]]:
    """NON-certified sketch-candidate duplicate scan.

    The middle path for spectrally flat corpora where
    :func:`sketch_duplicate_pairs` bails out: residual products swamp the
    bound so nothing PROVABLY prunes, but a true near-duplicate pair still
    tops its block row's sketch dots. Phase 1 keeps, for every 128-row
    block, its top-``cands_per_block`` column blocks by block maximum of
    the augmented-sketch dot (``ops/blockmax.py::blockpair_values``) plus
    its diagonal block; phase 2 rescores exactly like the certified scan
    (every EMITTED pair carries a true f32 score >= threshold — no false
    positives; only recall is heuristic).

    Callers MUST surface the approximate label (the engine sets
    ``last_duplicate_mode='approximate'``; /duplicates serves it)."""
    s_all, n_pad, slack, nb_real, rows_per_call = _prep_sketch(sl, sketch, rows_per_call, granule=COLS_TILE_V)
    # pairs whose UB falls below the compare point are still PROVABLY
    # clean — the candidate filter composes with the certified bound, it
    # just additionally drops low-ranked uncertifiable pairs
    floor = max(threshold - slack, 0.0)
    c = int(min(cands_per_block, n_pad // BLOCK))

    def _prog(frac: float) -> None:
        if progress is not None:
            progress(int(frac * 1000), 1000)

    # ---- phase 1: blockmax values sweep + per-block-row top-c ----------
    n_calls = n_pad // rows_per_call
    pend: list = []
    host_bi: List[np.ndarray] = []
    host_bj: List[np.ndarray] = []

    def _drain(entry):
        r0, vals, cols = entry
        vals = _from_host(vals)            # [rb, c] f32
        cols = _from_host(cols)            # [rb, c] int64
        rb = vals.shape[0]
        bi = np.repeat(np.arange(rb, dtype=np.int64) + r0 // BLOCK, c)
        bj = cols.reshape(-1).astype(np.int64)
        keep = (
            (vals.reshape(-1) > floor)
            & (bi < nb_real)
            & (bj < nb_real)
            & (bj >= bi)  # values kernel already -infs the lower triangle
        )
        host_bi.append(bi[keep])
        host_bj.append(bj[keep])

    for ci, r0 in enumerate(range(0, n_pad, rows_per_call)):
        vals = blockpair_values(s_all[r0 : r0 + rows_per_call], s_all, r0 // BLOCK)
        top_v, top_i = exact_topk(vals, c)
        pend.append((r0, _to_host_async(top_v), _to_host_async(top_i)))
        if len(pend) >= 2:
            _drain(pend.pop(0))
        _prog(0.45 * (ci + 1) / n_calls)
    while pend:
        _drain(pend.pop(0))
    _prog(0.5)

    del s_all
    # diagonal blocks always rescore (self-UB ~1 tops every row anyway,
    # but adjacent-row duplicates must never hinge on the ranking)
    diag = np.arange(nb_real, dtype=np.int64)
    bi = np.concatenate(host_bi + [diag])
    bj = np.concatenate(host_bj + [diag])
    pairs = np.unique(np.stack([bi, bj], axis=1), axis=0)
    bi, bj = pairs[:, 0], pairs[:, 1]

    # ---- phase 2: exact rescore — identical to the certified scan ------
    out = _rescore_pairs(sl, bi, bj, threshold, chunk_pairs, _prog)
    _prog(1.0)
    return out


def _rescore_pairs(sl: Slabs, bi, bj, threshold, chunk_pairs, prog) -> List[Tuple[int, int, float]]:
    """Exact-rescore the (bi, bj) block pairs, emitting every row pair with
    true f32 dot >= threshold, i < j. Shared phase 2 of the certified and
    the candidate (approximate) scans; ``prog`` is called with fractions in
    [0.5, 1.0]."""
    dev = sl.rows[0].device
    out: List[Tuple[int, int, float]] = []
    n_chunks = -(-len(bi) // chunk_pairs)
    for k, lo in enumerate(range(0, len(bi), chunk_pairs)):
        cbi = torch.from_numpy(bi[lo : lo + chunk_pairs]).to(dev)
        cbj = torch.from_numpy(bj[lo : lo + chunk_pairs]).to(dev)
        idx, v = _rescore_chunk(sl, cbi, cbj, threshold)
        idx = idx.cpu().numpy()
        p = idx // (BLOCK * BLOCK)
        rem = idx % (BLOCK * BLOCK)
        gi = bi[lo + p] * BLOCK + rem // BLOCK
        gj = bj[lo + p] * BLOCK + rem % BLOCK
        out.extend(zip(gi.tolist(), gj.tolist(), v.cpu().numpy().astype(float).tolist()))
        prog(0.5 + 0.5 * (k + 1) / n_chunks)
    return out
