"""The index's slab layout, read in one place.

``VectorIndex`` keeps its rows in slabs: parallel per-slab arrays of rows
(l2-normalized; f32, bf16 or int8), their norms, int8 scales and tombstone
penalties, next to a live ``size``. A global row id is the row's place in
the concatenation of the slabs. How slabs grow is the index's business; the
search, the two-stage search and the duplicate scans read a :class:`Slabs`
snapshot, and read rows only through :func:`gather` (by global id) and
:func:`gather_blocks` (by whole blocks).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import torch

from image_search_tpu_torch.ops.score_stream import row_norms

Parts = Tuple[torch.Tensor, ...]  # one tensor a slab


@dataclass(frozen=True)
class Slabs:
    """An immutable snapshot of the slab layout."""

    rows: Parts              # per slab [n_i, D]: f32, bf16 or int8
    norms: Parts             # per slab [n_i] f32: each row's norm before normalizing
    scales: Optional[Parts]  # per slab [n_i] f32 int8 row scales; None for f32 and bf16 rows
    pens: Optional[Parts]    # per slab [n_i] f32 additive penalties (0 live, NEG_INF removed); None before a removal
    size: int                # rows appended; rows at or past it are empty

    @cached_property
    def starts(self) -> Tuple[int, ...]:
        """Each slab's first global row."""
        out, start = [], 0
        for r in self.rows:
            out.append(start)
            start += r.shape[0]
        return tuple(out)

    @cached_property
    def capacity(self) -> int:
        return sum(r.shape[0] for r in self.rows)

    @property
    def dtype_name(self) -> str:
        """``"int8"``, ``"bfloat16"`` or ``"float32"``: the rows' dtype, as
        ``twostage.FULL_SCAN_SLACK`` keys it."""
        return str(self.rows[0].dtype).removeprefix("torch.")

    @property
    def is_int8(self) -> bool:
        return self.rows[0].dtype == torch.int8

    def per_slab(self):
        """Per slab: (rows, scales or None, pens or None, first global row)."""
        n = len(self.rows)
        return zip(self.rows, self.scales or (None,) * n, self.pens or (None,) * n, self.starts)


def l2(x: torch.Tensor) -> torch.Tensor:
    """Rows l2-normalized; each row's norm is independent of the batch
    (``row_norms``)."""
    return x / torch.clamp(row_norms(x), min=1e-12)


def gather(idx: torch.Tensor, *arrays: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Values at global rows ``idx`` (any shape) of each slabbed array, rows
    [n_i, D] or a vector [n_i] a slab -> one ``idx.shape`` (+ [D]) tensor an
    array, in its dtype; an id past every slab reads 0. One clamp and range
    test a slab, then one index and select a slab for each array."""
    outs, start = [None] * len(arrays), 0
    for parts in zip(*arrays):
        n = parts[0].shape[0]
        off = torch.clamp(idx - start, 0, n - 1)
        in_slab = (idx >= start) & (idx < start + n)
        for j, p in enumerate(parts):
            mask = in_slab.reshape(idx.shape + (1,) * (p.dim() - 1))
            outs[j] = torch.where(mask, p[off], 0 if outs[j] is None else outs[j])
        start += n
    return tuple(outs)


def dequantized(sl: Slabs, idx: torch.Tensor, raw: bool = False) -> torch.Tensor:
    """The stored (l2-normalized) rows at global ``idx`` -> ``idx.shape`` +
    [D] f32, int8 rows times their scales; ``raw=True``: times their norms
    too, the raw vectors."""
    int8 = sl.scales is not None
    got = gather(idx, sl.rows, *([sl.scales] if int8 else []), *([sl.norms] if raw else []))
    r = got[0].float()
    if int8:
        r = r * got[1][..., None]
    if raw:
        r = r * got[-1][..., None]
    return r


def gather_blocks(sl: Slabs, blocks: Sequence[torch.Tensor], block: int):
    """Whole ``block``-row blocks, ``blocks[i]`` holding slab i's chosen
    block ids (slab-local) -> (rows [R, D], scales [R] or None, pens [R] or
    None, global ids [R]), R = ``block`` times the blocks chosen, in slab
    order."""
    d = sl.rows[0].shape[1]
    rows, rscale, rpens, gid = [], [], [], []
    for (r, scale, pen, start), b in zip(sl.per_slab(), blocks):
        nb_i = r.shape[0] // block
        rows.append(r.view(nb_i, block, d)[b])
        if scale is not None:
            rscale.append(scale.view(nb_i, block)[b])
        if pen is not None:
            rpens.append(pen.view(nb_i, block)[b])
        gid.append((start + b[:, None] * block + torch.arange(block, device=b.device)).reshape(-1))
    n = sum(b.shape[0] for b in blocks) * block
    return (
        torch.cat(rows).reshape(n, d),
        torch.cat(rscale).reshape(n) if rscale else None,
        torch.cat(rpens).reshape(n) if rpens else None,
        torch.cat(gid),
    )
