"""Block-pair maxima of augmented-sketch dots: kernels B3 and B4 and their
plain PyTorch versions, the phase-1 sweep of the duplicate scan
(``index/dupscan.py``).

Each row carries its sketch and, as one extra coordinate, its residual norm,
``a_i = [s_i, t_i]``, so the dot ``a_i . a_j`` is the Cauchy-Schwarz upper
bound of the pair's cosine. For every pair of 128-row blocks the sweep takes
the maximum of those dots, upper triangle with the diagonal only:

- :func:`blockpair_mask` (B3, port of ``image_search_tpu/ops/blockmax.py::
  blockpair_mask``) thresholds the maxima and packs the bits: bit ``b`` of
  word ``out[br, wc]`` is column block ``wc * 32 + b``, LSB first, and is set
  iff the maximum is ``>= thr_minus_slack`` and the column block is not below
  the row block ``row_block0 + br``. A cleared bit proves that no pair of the
  two blocks reaches the threshold (``dupscan._pair_slack`` covers the bf16
  rounding of the operands and the f32 sum).
- :func:`blockpair_values` (B4, port of ``blockpair_values``) returns the
  maxima themselves, ``-inf`` below the diagonal, for the approximate scan.

On a CUDA tensor each launches ``csrc/blockmax.cu``; on a CPU tensor it runs
its plain version. The shape contract is the reference's: ``R`` a multiple of
``ROWS_TILE``, ``N`` of ``COLS_TILE`` (mask) or ``COLS_TILE_V`` (values).
"""

from __future__ import annotations

import torch

from image_search_tpu_torch import _build

BLOCK = 128          # rows per duplicate-scan block
ROWS_TILE = 1024     # row granule of a call (8 block rows)
COLS_TILE = 4096     # column granule of the mask (32 block columns = 1 word)
COLS_TILE_V = 4 * COLS_TILE  # column granule of the values
MAX_DEPTH = 80       # the kernel takes the depth in at most 5 k-steps of 16


def kernel_depth(da: int) -> int:
    """The depth d_a padded with zero columns to the kernel's k step of 16:
    80 for a 64-dim sketch plus its residual norm. Zero columns change no
    dot; rows of that depth are 16-byte aligned, as TMA reads them."""
    return -(-da // 16) * 16


def _check_shapes(name, s_rows, s_cols, col_granule):
    r, n = s_rows.shape[0], s_cols.shape[0]
    if s_rows.dtype != torch.bfloat16 or s_cols.dtype != torch.bfloat16:
        raise ValueError(f"{name}: sketches must be bf16, got {s_rows.dtype} and {s_cols.dtype}")
    if s_rows.ndim != 2 or s_cols.ndim != 2 or s_rows.shape[1] != s_cols.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(s_rows.shape)} and {tuple(s_cols.shape)} differ in depth")
    if r % ROWS_TILE or n % col_granule:
        raise ValueError(f"{name}: R={r} must be a multiple of {ROWS_TILE} and N={n} of {col_granule}")


def _block_maxima(s_rows, s_cols, row_block0: int):
    """[R/128, N/128] f32 maxima of the f32 product of the bf16 operands,
    computed in row tiles; -inf below the diagonal."""
    r, n = s_rows.shape[0], s_cols.shape[0]
    cols = s_cols.float()
    out = torch.empty((r // BLOCK, n // BLOCK), dtype=torch.float32, device=s_rows.device)
    for lo in range(0, r, ROWS_TILE):
        d = s_rows[lo : lo + ROWS_TILE].float() @ cols.T
        out[lo // BLOCK : (lo + ROWS_TILE) // BLOCK] = d.reshape(
            ROWS_TILE // BLOCK, BLOCK, n // BLOCK, BLOCK
        ).amax(dim=(1, 3))
    rowb = row_block0 + torch.arange(r // BLOCK, device=out.device)[:, None]
    colb = torch.arange(n // BLOCK, device=out.device)[None, :]
    return out.masked_fill_(colb < rowb, float("-inf"))


def blockpair_values_reference(s_rows, s_cols, row_block0: int):
    """Plain version of :func:`blockpair_values`."""
    return _block_maxima(s_rows, s_cols, int(row_block0))


def blockpair_mask_reference(s_rows, s_cols, thr_minus_slack: float, row_block0: int):
    """Plain version of :func:`blockpair_mask`: the bits of ``maxima >=
    thr`` packed LSB first into int32 words, as numpy packs them."""
    m = _block_maxima(s_rows, s_cols, int(row_block0))
    keep = (m >= thr_minus_slack).reshape(m.shape[0], -1, 32).long()  # -inf is never kept
    bit = torch.arange(32, device=m.device)
    words = (keep << bit).sum(dim=-1)  # uint32 values in int64
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _aligned(t, depth: int):
    """t itself when its rows are already 16-byte aligned at ``depth``, else
    a zero-padded [n, depth] copy."""
    if t.shape[1] == depth and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((t.shape[0], depth), dtype=t.dtype, device=t.device)
    out[:, : t.shape[1]] = t
    return out


def _launch(name, fn, s_rows, s_cols, out, *scalars):
    da = s_rows.shape[1]
    for t in (s_rows, s_cols):
        if t.device != s_rows.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: sketches must be contiguous on {s_rows.device}")
    if not 1 <= da <= MAX_DEPTH:
        raise ValueError(f"{name} kernel: depth {da} not in [1, {MAX_DEPTH}]")
    # TMA reads rows that start on 16 bytes: other operands are padded here,
    # a copy that counts in the call's time (dupscan pads its slab as it builds it)
    depth = da if da % 8 == 0 else kernel_depth(da)
    s_rows, s_cols = _aligned(s_rows, depth), _aligned(s_cols, depth)
    rc = fn(s_rows.data_ptr(), s_cols.data_ptr(), s_rows.shape[0], s_cols.shape[0], depth,
            *scalars, out.data_ptr(), _build.stream_handle(s_rows.device))
    _build.check(rc, f"{name} kernel launch")


def blockpair_mask(s_rows, s_cols, thr_minus_slack: float, row_block0: int):
    """Packed upper-triangle block-pair keep mask, [R/128, N/4096] int32.

    ``s_rows`` [R, d_a] bf16 (global block index ``row_block0`` at row 0),
    ``s_cols`` [N, d_a] bf16; see the module docstring for the bits."""
    _check_shapes("blockpair_mask", s_rows, s_cols, COLS_TILE)
    if s_rows.device.type == "cpu":
        return blockpair_mask_reference(s_rows, s_cols, thr_minus_slack, row_block0)
    if s_rows.device.type != "cuda":
        raise ValueError(f"blockpair_mask: no route for device {s_rows.device}")
    out = torch.empty(
        (s_rows.shape[0] // BLOCK, s_cols.shape[0] // COLS_TILE), dtype=torch.int32, device=s_rows.device
    )
    _launch("blockpair_mask", _build.lib().isx_blockpair_mask, s_rows, s_cols, out,
            float(thr_minus_slack), int(row_block0))
    blockpair_mask.launches += 1
    return out


def blockpair_values(s_rows, s_cols, row_block0: int):
    """Upper-triangle block-pair maxima, [R/128, N/128] f32 (-inf below the
    diagonal); operands as in :func:`blockpair_mask`."""
    _check_shapes("blockpair_values", s_rows, s_cols, COLS_TILE_V)
    if s_rows.device.type == "cpu":
        return blockpair_values_reference(s_rows, s_cols, row_block0)
    if s_rows.device.type != "cuda":
        raise ValueError(f"blockpair_values: no route for device {s_rows.device}")
    out = torch.empty(
        (s_rows.shape[0] // BLOCK, s_cols.shape[0] // BLOCK), dtype=torch.float32, device=s_rows.device
    )
    _launch("blockpair_values", _build.lib().isx_blockpair_values, s_rows, s_cols, out, int(row_block0))
    blockpair_values.launches += 1
    return out


blockpair_mask.launches = 0
blockpair_values.launches = 0
