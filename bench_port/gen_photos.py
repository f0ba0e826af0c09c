"""Synthetic photos from ``--seed``: JPEG files of a phone's size and weight.

Each photo's pixels are made on the device from a generator of its own
(smooth colour fields at three scales plus sensor-like grain, so that a
12 MP frame compresses to 2-5 MB as a phone's does), then encoded by PIL on
a few host threads. ``library`` hard-links a pool of distinct photos under
many distinct names: the index dedups by path, and a link costs no disk.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from bench_port import gen_corpus


def pixels(torch, seed: int, i: int, h: int, w: int, grain: float, device):
    """uint8 [h, w, 3] on the host."""
    F = torch.nn.functional
    gen = torch.Generator(device=device).manual_seed(gen_corpus.block_seed(seed, 1_000_000 + i))
    x = torch.full((1, 3, h, w), 128.0, device=device)
    for div, amp in ((256, 60.0), (48, 25.0), (8, 10.0)):
        n = torch.randn(1, 3, h // div + 3, w // div + 3, generator=gen, device=device) * amp
        x += F.interpolate(n, size=(h, w), mode="bicubic", align_corners=False)
    x += grain * torch.randn(1, 3, h, w, generator=gen, device=device)
    return x.clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0).contiguous().cpu().numpy()


def sizes(pool: int, long_side, short_side, portrait_share: float) -> list:
    """(h, w) of every pool photo: a fixed share in portrait."""
    n_portrait = round(portrait_share * pool)
    return [(long_side, short_side) if i < n_portrait else (short_side, long_side) for i in range(pool)]


def write_pool(torch, seed: int, directory: str, shapes: list, grain: float, quality: int, device,
               threads: int = 8, content=None) -> list:
    """The pool's JPEG files -> their paths. File i holds the pixels of
    photo ``content[i]`` of ``seed`` (photo i by default)."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = [os.path.join(directory, f"pool_{i:04d}.jpg") for i in range(len(shapes))]

    def encode(args):
        path, arr = args
        Image.fromarray(arr).save(path, "JPEG", quality=quality)

    with ThreadPoolExecutor(threads) as ex:
        content = range(len(shapes)) if content is None else content
        futures = [ex.submit(encode, (p, pixels(torch, seed, c, h, w, grain, device)))
                   for c, p, (h, w) in zip(content, paths, shapes)]
        for f in futures:
            f.result()
    return paths


def link_name(i: int) -> str:
    return f"d{i // 1000:04d}/photo_{i:07d}.jpg"


def library(root: str, pool: list, first: int, count: int) -> None:
    """Photos ``first .. first+count-1`` under ``root``: photo i is a hard
    link to pool photo i mod len(pool)."""
    made = set()
    for i in range(first, first + count):
        rel = link_name(i)
        d = os.path.join(root, os.path.dirname(rel))
        if d not in made:
            os.makedirs(d, exist_ok=True)
            made.add(d)
        os.link(pool[i % len(pool)], os.path.join(root, rel))


def pool_index(path: str, pool_size: int) -> int:
    return int(path.rsplit("_", 1)[-1][:-4]) % pool_size
