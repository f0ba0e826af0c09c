"""The plain reference of ``/search`` over an int8 corpus, and the numbers
that compare a served answer with it.

The configuration states int8 rows: each row l2-normalised and rounded to
int8 with one scale (its largest magnitude / 127, half to even), its norm
kept in f32; the query (the text tower's raw embedding, or with marked
results Rocchio's average of their stored raw vectors and the text's, as
the reference server's ``search.rs`` defines it) l2-normalised and rounded
to int8 the same way; a score is the integer dot product times both scales.
The answer is the k best scores. This module computes that in plain torch
from the corpus generator and the reference CLIP, in blocks of rows.

``lowp=True`` is the control: the text tower in fp8 and rows and queries
in int4 (the step below the int8 the configuration states).
"""

from __future__ import annotations

import torch

from bench_port import gen_corpus
from bench_port.reference.clip import Clip, f32_exact, hash_tokens


def quantize(x: torch.Tensor, levels: int = 127):
    """[N, D] f32 -> (integer values as f32, f32 scales), symmetric."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels), scale[:, 0]


def _stored(raw: torch.Tensor, levels: int):
    """Raw rows -> (integer rows, scales, norms): what the index stores."""
    norms = torch.linalg.vector_norm(raw, dim=-1)
    q, s = quantize(raw / norms.clamp(min=1e-12)[:, None], levels)
    return q, s, norms


def answers(m: dict, state: dict, corpus: dict, seed: int, requests: list, k: int, device, lowp: bool = False,
            look_up=None):
    """For each request {"q": text, "refs": [row ids]}: (top-k row ids, their
    scores, best first, over the corpus made from ``seed``; {row: score} of
    the rows ``look_up[i]`` names)."""
    levels = 7 if lowp else 127
    total, block_rows = corpus["rows"], corpus["block_rows"]
    with torch.no_grad(), f32_exact():
        model = Clip(m, state, lowp="fp8" if lowp else None)
        tc = m["text"]
        ids = hash_tokens([r["q"] for r in requests], tc["vocab_size"], tc["context_length"], tc["eos_token_id"])
        text = model.encode_text(ids.to(device))
        del model
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
        for i, r in enumerate(requests):
            if r["refs"]:
                sel = torch.stack([raw_sel[row] for row in r["refs"]]).mean(dim=0)
                queries.append((sel + text[i]) * 0.5)
            else:
                queries.append(text[i])
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


def compare(served: list, ref_ids: torch.Tensor, ref_scores: torch.Tensor, ref_all: list, k: int) -> dict:
    """Numbers for a set of served answers against the reference.

    ``served[i]`` is [(row, score)] best first; ``ref_all[i]`` maps every
    served row to its reference score. ``score_gap``: the widest gap between
    a served score and the reference's score of that row. ``rank_gap``: the
    widest margin by which a served row's reference score lies below the
    reference's k-th best (0 when every served row is in its top k).
    ``malformed``: answers of the wrong length, with a row twice, or out of
    order."""
    score_gap = rank_gap = 0.0
    malformed = 0
    for i, ans in enumerate(served):
        rows = [r for r, _ in ans]
        want = min(k, ref_ids.shape[1])
        if len(ans) != want or len(set(rows)) != len(rows) or any(a[1] < b[1] for a, b in zip(ans, ans[1:])):
            malformed += 1
            continue
        kth = float(ref_scores[i, want - 1])
        for row, score in ans:
            ref = ref_all[i][row]
            score_gap = max(score_gap, abs(score - ref))
            rank_gap = max(rank_gap, kth - ref)
    return {"score_gap": score_gap, "rank_gap": rank_gap, "malformed": malformed}
