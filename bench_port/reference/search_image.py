"""The plain reference of ``/search_image`` over an int8 corpus.

As ``reference/search.py`` defines ``/search``, with the uploaded photo in
the text's place: the photo through ``reference/clip.py::preprocess`` at the
configuration's image size and the f32 vision tower (its raw embedding);
with marked results, Rocchio's average of their stored raw vectors and the
photo's; the query l2-normalised and rounded to int8 with one scale; a score
the integer dot product times both scales; the exact top k of all rows, in
blocks. ``lowp=True`` is the control: the vision tower in fp8, rows and
query in int4 (the step below the int8 the configuration states).
"""

from __future__ import annotations

import torch

from bench_port import gen_corpus
from bench_port.reference.clip import Clip, f32_exact, preprocess
from bench_port.reference.search import _stored, quantize


def embed_photos(m: dict, state: dict, paths: list, device, lowp: bool = False, batch: int = 16) -> dict:
    """{path: raw f32 embedding} of each distinct photo file."""
    distinct = sorted(set(paths))
    out = {}
    with torch.no_grad(), f32_exact():
        model = Clip(m, state, lowp="fp8" if lowp else None)
        for lo in range(0, len(distinct), batch):
            part = distinct[lo : lo + batch]
            px = torch.stack([preprocess(p, m["vision"]["image_size"]) for p in part]).to(device)
            for p, e in zip(part, model.encode_image(px)):
                out[p] = e
    return out


def answers(m: dict, state: dict, corpus: dict, seed: int, requests: list, k: int, device, lowp: bool = False,
            look_up=None):
    """For each request {"photo": JPEG path, "refs": [row ids]}: (top-k row
    ids, their scores, best first, over the corpus made from ``seed``;
    {row: score} of the rows ``look_up[i]`` names)."""
    levels = 7 if lowp else 127
    total, block_rows = corpus["rows"], corpus["block_rows"]
    photos = embed_photos(m, state, [r["photo"] for r in requests], device, lowp)
    with torch.no_grad(), f32_exact():
        mix = gen_corpus.mix_matrix(torch, seed, corpus["rank"], m["projection_dim"], device)
        wanted = sorted({row for r in requests for row in r["refs"]})
        raw_sel = {}
        for b, lo, rows in gen_corpus.blocks(total, block_rows):
            here = [row for row in wanted if lo <= row < lo + rows]
            if not here:
                continue
            q, s, n = _stored(gen_corpus.block(torch, seed, b, rows, mix, corpus["noise"]), levels)
            local = torch.tensor([row - lo for row in here], device=device)
            vec = q[local] * s[local, None] * n[local, None]
            for j, row in enumerate(here):
                raw_sel[row] = vec[j]
        queries = []
        for r in requests:
            img = photos[r["photo"]]
            if r["refs"]:
                sel = torch.stack([raw_sel[row] for row in r["refs"]]).mean(dim=0)
                queries.append((sel + img) * 0.5)
            else:
                queries.append(img)
        qv = torch.stack(queries)
        qi, qs = quantize(qv / torch.linalg.vector_norm(qv, dim=-1, keepdim=True).clamp(min=1e-12), levels)
        look_up = look_up or [[] for _ in requests]
        found = [dict() for _ in requests]
        best_v = torch.full((len(requests), 0), 0.0, device=device)
        best_i = torch.zeros((len(requests), 0), dtype=torch.long, device=device)
        for b, lo, rows in gen_corpus.blocks(total, block_rows):
            q, s, _ = _stored(gen_corpus.block(torch, seed, b, rows, mix, corpus["noise"]), levels)
            scores = (qi @ q.t()) * qs[:, None] * s[None, :]
            for j, rows_j in enumerate(look_up):
                here = [row for row in rows_j if lo <= row < lo + rows]
                if here:
                    got = scores[j, torch.tensor([row - lo for row in here], device=device)].tolist()
                    found[j].update(zip(here, got))
            v = torch.cat([best_v, scores], dim=1)
            i = torch.cat([best_i, torch.arange(lo, lo + rows, device=device).expand(len(requests), rows)], dim=1)
            top = torch.topk(v, min(k, v.shape[1]), dim=1)
            best_v, best_i = top.values, torch.gather(i, 1, top.indices)
    return best_i.cpu(), best_v.cpu(), found
