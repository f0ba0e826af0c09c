"""A search cell's corpus, made on the device from ``--seed``.

Clustered rows: a rank-``rank`` mix of unit directions plus Gaussian noise
(the generator of ``chip_smoke.py::_slabs_on_device``), in blocks of
``block_rows`` that each have a generator of their own, so the reference
can make any block again without the others. Row ``r`` is the photo
``lib/<r // 1000>/<r>.jpg`` under the media directory.
"""

from __future__ import annotations

import math

MASK = (1 << 63) - 1


def block_seed(seed: int, block: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + (block + 2) * 0xBF58476D1CE4E5B9) & MASK


def mix_matrix(torch, seed: int, rank: int, dim: int, device):
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, -1))
    return torch.randn(rank, dim, generator=gen, device=device) / math.sqrt(dim)


def block(torch, seed: int, b: int, rows: int, mix, noise: float):
    """Raw f32 rows of block ``b`` [rows, dim] on mix's device."""
    gen = torch.Generator(device=mix.device).manual_seed(block_seed(seed, b))
    e = torch.randn(rows, mix.shape[0], generator=gen, device=mix.device) @ mix
    e += noise * torch.randn(rows, mix.shape[1], generator=gen, device=mix.device)
    return e


def blocks(total: int, block_rows: int):
    """(block index, first row, rows) of every block."""
    for b, lo in enumerate(range(0, total, block_rows)):
        yield b, lo, min(block_rows, total - lo)


def rel_path(row: int) -> str:
    return f"lib/{row // 1000:05d}/{row:08d}.jpg"


def row_of(media_path: str) -> int:
    """'media/lib/00012/00012345.jpg' -> 12345 (ValueError otherwise)."""
    name = media_path.rsplit("/", 1)[-1]
    if not (media_path.startswith("media/lib/") and name.endswith(".jpg")):
        raise ValueError(f"not a corpus path: {media_path!r}")
    return int(name[:-4])
