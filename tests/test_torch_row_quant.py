"""The append transform (``ops/row_quant.py``) against the JAX package's host
path, bitwise: ``np.linalg.norm``, the divide, and ``VectorIndex.
_quantize_host`` for int8, bf16 and f32 rows, at the widths of the presets
and at widths that give numpy's pairwise sum every shape (a short run, one
run with a remainder, uneven splits). The kernel's plan is walked here in
numpy as ``csrc/row_quant.cu`` walks it, so its table is checked on the CPU;
the kernel itself is checked on the card (tests/test_torch_cuda.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from image_search_tpu.index import VectorIndex as JaxIndex
from image_search_tpu_torch.index import index as index_mod
from image_search_tpu_torch.index.index import VectorIndex
from image_search_tpu_torch.ops.row_quant import kernel_plan, normalize_rows_into, normalize_rows_reference

WIDTHS = [1, 5, 32, 64, 100, 129, 136, 257, 512, 768, 1024, 1280]
FORMATS = {"int8": torch.int8, "bfloat16": torch.bfloat16, None: torch.float32}


def tie_row(d, rng):
    """Norm 128 and max|x| 127, so y = x / 128 and scale = 1 / 128 exactly
    and y / scale = x: the entries 0.5, 1.5, 15.5, 3.5 are exact ties."""
    row = np.zeros(d, np.float32)
    row[:5] = [127, 0.5, 1.5, 15.5, 3.5]
    return rng.permutation(row * rng.choice([-1, 1], size=d)).astype(np.float32)


def edge_rows(d, seed):
    rng = np.random.default_rng(seed)
    rows = [np.zeros(d, np.float32)]
    one_hot = np.zeros(d, np.float32)
    one_hot[rng.integers(d)] = 3.0
    rows.append(one_hot)
    if d >= 5:
        rows += [tie_row(d, rng) for _ in range(3)]
    rows += [rng.normal(size=d).astype(np.float32) * np.float32(s) for s in (1e-20, 1e20)]
    scale = rng.uniform(0.01, 100.0, size=(61, 1)).astype(np.float32)
    return np.concatenate([np.stack(rows), rng.normal(size=(61, d)).astype(np.float32) * scale])


def host_path(x, quantize):
    """The JAX package's append transform, as it runs in
    ``image_search_tpu/index/index.py``."""
    with np.errstate(over="ignore"):
        norms = np.linalg.norm(x, axis=1)
    normalized = x / np.maximum(norms, 1e-12)[:, None]
    rows, scales = JaxIndex._quantize_host(SimpleNamespace(quantize=quantize), normalized)
    return np.asarray(rows), norms.astype(np.float32), scales


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.int8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return bits(t.numpy())


@pytest.mark.parametrize("quantize", list(FORMATS), ids=["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_version_is_bitwise_the_host_path(d, quantize):
    x = edge_rows(d, seed=d)
    want_rows, want_norms, want_scales = host_path(x, quantize)
    rows, norms, scales = normalize_rows_reference(torch.from_numpy(x), FORMATS[quantize])
    np.testing.assert_array_equal(torch_bits(rows), bits(want_rows))
    np.testing.assert_array_equal(torch_bits(norms), bits(want_norms))
    if quantize == "int8":
        np.testing.assert_array_equal(torch_bits(scales), bits(want_scales))
        if d >= 5:  # the tie rows round half to even
            ties = rows[2:5].numpy().astype(np.int64)
            assert sorted(np.abs(ties[0][ties[0] != 0]).tolist()) == [2, 4, 16, 127]
    else:
        assert scales is None


def walk_plan(x):
    """``csrc/row_quant.cu``'s arithmetic, row by row in numpy f32, from the
    table of ``kernel_plan`` -> (norms, max|x| / max(norm, 1e-12))."""
    d = x.shape[1]
    table, C, L = kernel_plan(d)
    t = np.asarray(table)
    chains, leaves, combines = t[: 3 * C].reshape(C, 3), t[3 * C : 3 * C + 4 * L].reshape(L, 4), t[3 * C + 4 * L :].reshape(-1, 2)
    f = np.float32
    norms, amaxes = [], []
    with np.errstate(over="ignore"):
        for row in x:
            seen = np.zeros(d, bool)
            s_chain = []
            for start, count, stride in chains:
                idx = start + stride * np.arange(count)
                seen[idx] = True
                s = f(row[idx[0]] * row[idx[0]])
                for i in idx[1:]:
                    s = f(s + f(row[i] * row[i]))
                s_chain.append(s)
            nodes = []
            for first, nchain, tail, ntail in leaves:
                r = s_chain[first : first + nchain]
                s = r[0] if nchain == 1 else f(f(f(r[0] + r[1]) + f(r[2] + r[3])) + f(f(r[4] + r[5]) + f(r[6] + r[7])))
                for i in range(tail, tail + ntail):
                    seen[i] = True
                    s = f(s + f(row[i] * row[i]))
                nodes.append(s)
            for a, b in combines:
                nodes.append(f(nodes[a] + nodes[b]))
            assert seen.all() and len(nodes) == 2 * L - 1
            norm = np.sqrt(nodes[-1])
            norms.append(norm)
            amaxes.append(f(np.abs(row).max() / max(norm, f(1e-12))))
    return np.array(norms, np.float32), np.array(amaxes, np.float32)


@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_plan_walk_is_bitwise_the_host_path(d):
    x = edge_rows(d, seed=1000 + d)[:24]
    norms, amax = walk_plan(x)
    with np.errstate(over="ignore"):
        want = np.linalg.norm(x, axis=1)
    np.testing.assert_array_equal(bits(norms), bits(want))
    normalized = x / np.maximum(want, 1e-12)[:, None]
    np.testing.assert_array_equal(bits(amax), bits(np.abs(normalized).max(axis=1)))


@pytest.mark.parametrize("chunk", [16384, 3000])
@pytest.mark.parametrize("quantize", list(FORMATS), ids=["int8", "bf16", "f32"])
def test_cpu_index_writes_the_plain_version_across_slabs(quantize, chunk, monkeypatch):
    """4096-row adds through the first slab's doubling and a slab boundary
    (one write a chunk within each slab the rows reach), and the rows around
    each write kept."""
    monkeypatch.setattr(index_mod, "_APPEND_ROWS", chunk)
    d, sizes = 32, [4096, 4096, 1000, 5192, 4096, 777]
    x = np.random.default_rng(7).normal(size=(sum(sizes), d)).astype(np.float32)
    idx = VectorIndex(d, device="cpu", quantize=quantize, slab_rows=16384)
    off = 0
    for n in sizes:
        assert idx.add([f"/p/{i}.jpg" for i in range(off, off + n)], x[off : off + n]) == n
        off += n
    assert off == len(x) and len(idx._emb_slabs) == 2
    rows, norms, scales = normalize_rows_reference(torch.from_numpy(x), FORMATS[quantize])
    got = lambda slabs: torch.cat(list(slabs))[: len(x)]
    np.testing.assert_array_equal(torch_bits(got(idx._emb_slabs)), torch_bits(rows))
    np.testing.assert_array_equal(torch_bits(got(idx._norm_slabs)), torch_bits(norms))
    if scales is not None:
        np.testing.assert_array_equal(torch_bits(got(idx._scale_slabs)), torch_bits(scales))
    assert not torch.cat(list(idx._emb_slabs))[len(x) :].any()


def test_into_writes_only_its_slice():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(37, 768)).astype(np.float32))
    rows = torch.full((100, 768), 5, dtype=torch.int8)
    norms, scales = torch.full((100,), -1.0), torch.full((100,), -1.0)
    normalize_rows_into(x, rows[40:77], norms[40:77], scales[40:77])
    want = normalize_rows_reference(x, torch.int8)
    assert torch.equal(rows[40:77], want[0]) and torch.equal(norms[40:77], want[1]) and torch.equal(scales[40:77], want[2])
    assert (rows[:40] == 5).all() and (rows[77:] == 5).all()
    assert (norms[:40] == -1).all() and (scales[77:] == -1).all()
