"""The index's slab layout (``index/slabs.py``): the one gather against the
concatenated slabs, the snapshot's derived fields, and the package's import
direction (``ops <- slabs <- {twostage, dupscan} <- index``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_search_tpu_torch.index.index import VectorIndex
from image_search_tpu_torch.index.slabs import Slabs, dequantized, gather, gather_blocks

SLAB_ROWS = (256, 128, 384)  # three slabs of unequal length
DIM = 16
SIZE = 700  # the live size: the last slab's tail is empty


def _slabs(quantize=None, pens=True) -> Slabs:
    g = torch.Generator().manual_seed(5)
    rows, norms, scales, pen = [], [], [], []
    for n in SLAB_ROWS:
        if quantize == "int8":
            rows.append(torch.randint(-127, 128, (n, DIM), generator=g, dtype=torch.int8))
        else:
            rows.append(torch.randn(n, DIM, generator=g).to(torch.bfloat16 if quantize else torch.float32))
        norms.append(torch.rand(n, generator=g) + 0.5)
        scales.append(torch.rand(n, generator=g) / 127)
        pen.append(torch.where(torch.rand(n, generator=g) < 0.1, -3.0e38, 0.0))
    return Slabs(
        rows=tuple(rows), norms=tuple(norms), scales=tuple(scales) if quantize == "int8" else None,
        pens=tuple(pen) if pens else None, size=SIZE,
    )


def _edges(sl: Slabs) -> torch.Tensor:
    """Every slab's first and last row, the last live row and the first row
    past the live size."""
    ids = [x for s, r in zip(sl.starts, sl.rows) for x in (s, s + r.shape[0] - 1)]
    return torch.tensor(sorted(set(ids + [sl.size - 1, sl.size])))


@pytest.mark.parametrize("shape", ["flat", "batched"])
@pytest.mark.parametrize("field", ["rows", "norms", "pens"])
def test_gather_is_the_concatenation_indexed(field, shape):
    sl = _slabs()
    parts = getattr(sl, field)
    idx = _edges(sl)
    if shape == "batched":  # a [B, c] index, as the two-stage rescore reads candidates
        idx = torch.stack([idx, idx.flip(0), torch.roll(idx, 3)])
    (got,) = gather(idx, parts)
    want = torch.cat(parts)[idx]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_gather_reads_several_arrays_at_once():
    sl = _slabs("int8")
    idx = _edges(sl)[None, :].expand(2, -1)
    got = gather(idx, sl.rows, sl.scales, sl.norms, sl.pens)
    for g, parts in zip(got, (sl.rows, sl.scales, sl.norms, sl.pens)):
        assert g.dtype == parts[0].dtype and torch.equal(g, torch.cat(parts)[idx])


@pytest.mark.parametrize("quantize", [None, "bfloat16", "int8"])
def test_dequantized_rows_are_the_stored_rows_times_scale(quantize):
    sl = _slabs(quantize)
    idx = _edges(sl)
    want = torch.cat(sl.rows)[idx].float()
    if quantize == "int8":
        want = want * torch.cat(sl.scales)[idx][:, None]
    assert torch.equal(dequantized(sl, idx), want)
    assert torch.equal(dequantized(sl, idx, raw=True), want * torch.cat(sl.norms)[idx][:, None])


def test_gather_past_every_slab_reads_zero():
    sl = _slabs("int8")
    idx = torch.tensor([sl.capacity, sl.capacity + 5])
    rows, pens = gather(idx, sl.rows, sl.pens)
    assert rows.shape == (2, DIM) and not rows.any() and not pens.any()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_gather_blocks_reads_whole_blocks_in_slab_order(quantize):
    sl = _slabs(quantize)
    blocks = [torch.tensor([1, 0]), torch.tensor([0]), torch.tensor([2])]
    rows, scales, pens, gid = gather_blocks(sl, blocks, 128)
    want = torch.cat([torch.arange(128, 256), torch.arange(128), torch.arange(256, 384), torch.arange(640, 768)])
    assert torch.equal(gid, want)
    assert torch.equal(rows, torch.cat(sl.rows)[want]) and torch.equal(pens, torch.cat(sl.pens)[want])
    assert (scales is None) == (quantize is None)
    if scales is not None:
        assert torch.equal(scales, torch.cat(sl.scales)[want])


@pytest.mark.parametrize("quantize", [None, "bfloat16", "int8"])
def test_snapshot_is_the_index_layout(quantize):
    idx = VectorIndex(DIM, device="cpu", quantize=quantize, min_capacity=4096, slab_rows=4096)
    x = np.random.default_rng(1).normal(size=(9000, DIM)).astype(np.float32)
    idx.add([f"p{i}" for i in range(len(x))], x)
    sl = idx._snapshot()
    assert sl.size == 9000 and sl.capacity == idx.capacity and sl.pens is None
    assert sl.starts == (0, 4096, 8192) and len(sl.rows) == len(idx._emb_slabs)
    assert sl.dtype_name == {None: "float32", "bfloat16": "bfloat16", "int8": "int8"}[quantize]
    assert sl.is_int8 == (quantize == "int8") and (sl.scales is not None) == sl.is_int8
    idx.remove_paths(["p4096"])
    after = idx._snapshot()
    assert after.pens is not None and float(gather(torch.tensor([4096]), after.pens)[0]) < 0
    np.testing.assert_allclose(idx.get_raw_embeddings(["p0", "p8999"]), x[[0, 8999]], rtol=0.02, atol=0.02)


def test_twostage_and_dupscan_do_not_load_the_index_module():
    """The import direction holds: the two-stage search and the duplicate
    scan read the slabs without importing ``index.index``."""
    code = (
        "import sys, image_search_tpu_torch.index.twostage, image_search_tpu_torch.index.dupscan;"
        "print('image_search_tpu_torch.index.index' in sys.modules)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=root)
    assert out.stdout.strip() == "False"
