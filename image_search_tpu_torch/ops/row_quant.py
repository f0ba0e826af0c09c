"""Appended rows, l2-normalized and stored in the index's row format.

The JAX package transforms the rows of an append in numpy on the host
(``image_search_tpu/index/index.py::_add_in_memory_locked`` and
``_quantize_host``); no Pallas kernel does it. For each raw f32 row x:

- ``norm = np.linalg.norm(x)``: the squares summed in numpy's pairwise
  order (:func:`pairwise_plan`), then a square root;
- ``y = x / max(norm, 1e-12)``;
- int8 rows: ``scale = max(max|y|, 1e-12) / 127`` and
  ``q = clip(round(y / scale), -127, 127)``, rounding half to even;
- bf16 rows: ``y`` rounded to nearest even; f32 rows: ``y``.

Every step is one round-to-nearest f32 operation, so the result has one
right answer. :func:`normalize_rows_reference` is the plain PyTorch version
of that arithmetic in that order (bitwise numpy's on the CPU), and
:func:`normalize_rows_into` writes it into the index's slab slices: on a CUDA
tensor by one launch of ``csrc/row_quant.cu`` (bitwise the plain version),
on a CPU tensor by the plain version.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from image_search_tpu_torch import _build

PW_BLOCK = 128  # numpy's PW_BLOCKSIZE: the longest run one unrolled loop sums
UNROLL = 8  # numpy's accumulators within a run
FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SMEM_LIMIT = 48 * 1024  # shared memory a block takes without opting in (csrc/row_quant.cu)


@functools.lru_cache(maxsize=None)
def pairwise_plan(d: int) -> Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int], ...]]:
    """numpy's ``pairwise_sum`` of ``d`` contiguous f32 values (what
    ``np.add.reduce`` runs over each row of ``np.linalg.norm(x, axis=1)``)
    -> (leaves, combines).

    A run of at most ``PW_BLOCK`` values is a leaf: below ``UNROLL`` values
    a running sum in order; else ``UNROLL`` accumulators, accumulator j
    summing values j, j + 8, ... of the run's multiple of 8, combined as
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the remaining
    values added in order. A longer run splits at ``n2 = n // 2 - (n // 2) % 8``
    into two halves summed alike and added. ``leaves`` holds (offset, length)
    in order; node k < len(leaves) is leaf k, node len(leaves) + j is
    ``combines[j] = (a, b)``, the sum of nodes a and b; the last node is the
    total."""
    if d < 1:
        raise ValueError(f"pairwise_plan: width {d} < 1")
    leaves: List[Tuple[int, int]] = []
    combines: List[Tuple[int, int]] = []

    def split(off: int, n: int):
        if n <= PW_BLOCK:
            leaves.append((off, n))
            return ("leaf", len(leaves) - 1)
        n2 = n // 2 - (n // 2) % UNROLL
        a, b = split(off, n2), split(off + n2, n - n2)
        combines.append((a, b))
        return ("combine", len(combines) - 1)

    split(0, d)
    node = lambda ref: ref[1] if ref[0] == "leaf" else len(leaves) + ref[1]
    return tuple(leaves), tuple((node(a), node(b)) for a, b in combines)


def pairwise_sums(sq: torch.Tensor) -> torch.Tensor:
    """[n, D] f32 -> [n] f32 row sums in numpy's pairwise order
    (:func:`pairwise_plan`), each a chain of elementwise f32 adds; leaves of
    one length are summed side by side."""
    n, d = sq.shape
    leaves, combines = pairwise_plan(d)
    nodes: List[torch.Tensor] = [None] * (len(leaves) + len(combines))
    for length in sorted({ln for _, ln in leaves}):
        ks = [k for k, (_, ln) in enumerate(leaves) if ln == length]
        cols = torch.tensor([leaves[k][0] for k in ks])[:, None] + torch.arange(length)
        v = sq[:, cols]  # [n, leaves, length]
        if length < UNROLL:
            s = v[..., 0]
            for i in range(1, length):
                s = s + v[..., i]
        else:
            m = length - length % UNROLL
            r = v[..., :m].unflatten(-1, (m // UNROLL, UNROLL))
            acc = r[:, :, 0]
            for i in range(1, m // UNROLL):
                acc = acc + r[:, :, i]
            a = [acc[..., j] for j in range(UNROLL)]
            s = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]))
            for t in range(m, length):
                s = s + v[..., t]
        for j, k in enumerate(ks):
            nodes[k] = s[:, j]
    for j, (a, b) in enumerate(combines):
        nodes[len(leaves) + j] = nodes[a] + nodes[b]
    return nodes[-1]


def normalize_rows_reference(x: torch.Tensor, dtype: torch.dtype):
    """Plain version: raw f32 rows [n, D] -> (rows [n, D] in ``dtype``,
    norms [n] f32, scales [n] f32 for int8 else None)."""
    x = x.float()
    # torch's f32 sqrt on the CPU is not always correctly rounded (~0.5% of
    # values differ from IEEE's by an ulp); the f64 root of an f32 value,
    # rounded to f32, is (53 bits >= 2 * 24 + 2: the double rounding is harmless)
    norms = torch.sqrt(pairwise_sums(x * x).double()).float()
    y = x / torch.clamp(norms, min=1e-12)[:, None]
    if dtype == torch.int8:
        scale = torch.clamp(y.abs().amax(dim=1), min=1e-12) / 127.0
        q = torch.clamp(torch.round(y / scale[:, None]), -127, 127).to(torch.int8)
        return q, norms, scale
    return y.to(dtype), norms, None


@functools.lru_cache(maxsize=None)
def kernel_plan(d: int) -> Tuple[Tuple[int, ...], int, int]:
    """:func:`pairwise_plan` flattened for ``csrc/row_quant.cu`` -> (int32
    table, chains, leaves). A chain is one running sum (start, count,
    stride): a leaf of ``UNROLL`` or more values has ``UNROLL`` (stride 8),
    a shorter one one (stride 1). The table holds the chains, then per leaf
    (first chain, chains, first remaining value, remaining values), then
    per combine (a, b)."""
    leaves, combines = pairwise_plan(d)
    chains: List[int] = []
    leaf_rows: List[int] = []
    for off, length in leaves:
        first = len(chains) // 3
        if length < UNROLL:
            chains += [off, length, 1]
            leaf_rows += [first, 1, off + length, 0]
        else:
            m = length - length % UNROLL
            for j in range(UNROLL):
                chains += [off + j, m // UNROLL, UNROLL]
            leaf_rows += [first, UNROLL, off + m, length - m]
    table = tuple(chains + leaf_rows + [v for ab in combines for v in ab])
    return table, len(chains) // 3, len(leaves)


@functools.lru_cache(maxsize=None)
def _device_plan(d: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(kernel_plan(d)[0], dtype=torch.int32, device=device)


def _check_cuda_operands(x, rows, norms, scales):
    n, d = x.shape
    want = [
        ("x", x, (torch.float32,), (n, d)),
        ("rows", rows, tuple(FORMATS), (n, d)),
        ("norms", norms, (torch.float32,), (n,)),
    ]
    if rows.dtype == torch.int8 or scales is not None:
        want.append(("scales", scales, (torch.float32,), (n,)))
    for name, t, dtypes, shape in want:
        if t is None or t.device != x.device or t.dtype not in dtypes or tuple(t.shape) != shape or not t.is_contiguous():
            got = "None" if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(f"row_quant kernel: {name} must be a contiguous {dtypes} {shape} on {x.device}, got {got}")
    if rows.dtype != torch.int8 and scales is not None:
        raise ValueError("row_quant kernel: scales are written for int8 rows only")
    _, c, lv = kernel_plan(d)
    if 4 * (c + 2 * lv - 1) > SMEM_LIMIT:  # a float a chain and a tree node, a warp
        raise ValueError(f"row_quant kernel: D={d} needs more than {SMEM_LIMIT} bytes of shared memory a row")


def normalize_rows_into(x: torch.Tensor, rows: torch.Tensor, norms: torch.Tensor, scales=None) -> None:
    """Raw f32 rows x [n, D] -> ``rows`` [n, D] (f32, bf16 or int8: its
    dtype is the format), ``norms`` [n] f32 and, for int8, ``scales`` [n]
    f32, written in place (the index passes its slab slices). On a CUDA
    tensor one launch of ``csrc/row_quant.cu`` on the current stream, counted
    in ``launches``; on a CPU tensor the plain version."""
    if x.device.type == "cpu":
        r, nm, sc = normalize_rows_reference(x, rows.dtype)
        rows.copy_(r)
        norms.copy_(nm)
        if sc is not None:
            scales.copy_(sc)
        return
    if x.device.type != "cuda":
        raise ValueError(f"normalize_rows_into: no route for device {x.device}")
    _check_cuda_operands(x, rows, norms, scales)
    n, d = x.shape
    if n == 0:
        return
    _, c, lv = kernel_plan(d)
    rc = _build.lib().isx_row_quant(
        x.data_ptr(), rows.data_ptr(), norms.data_ptr(), None if scales is None else scales.data_ptr(),
        n, d, FORMATS[rows.dtype], _device_plan(d, x.device).data_ptr(), c, lv,
        _build.stream_handle(x.device),
    )
    _build.check(rc, "row_quant kernel launch")
    normalize_rows_into.launches += 1


normalize_rows_into.launches = 0
