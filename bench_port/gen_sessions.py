"""Closed-loop traffic of a cell, made from its mix and ``--seed`` alone.

A mix with ``sessions`` (and ``rate_per_s`` null) runs that many sessions,
each sending its next request the moment its previous answer arrives
(``loadgen_closed.py``), from ``warmup_s`` before the window to its close.
A session's requests come in blocks of ``BLOCK``, each one fixed multiset of
kinds (``new_share`` new), word counts and mark counts in the seed's order,
so every seed and session asks for the same work a block. A new request is a
new text (kind ``search``: ``gen_search``'s vocabulary) or a new photo of
the pool (kind ``search_image``: session s's k-th is pool photo
``s + k * sessions`` in the seed's order, so the sessions share the pool
evenly); a refinement sends the session's text or photo again with 1-5 of
the top ``mark_from_top`` results of its own previous answer marked.

Each request carries ``pick``: its place in the check's sample
(``check_caps``), which ``loadgen_closed._Sample`` draws as answers arrive.
"""

from __future__ import annotations

import itertools
import random

from bench_port import gen_search

BLOCK = 10  # a session's requests a block: one fixed multiset of kinds, words and marks


def sessions(mix: dict, seed: int) -> list:
    """One endless iterator a session, of its requests in the order it sends
    them: ``{"q"`` or ``"photo", "kind", "ranks", "pick"}``, ``ranks`` the
    ranks of the previous answer that a refinement marks."""
    n = mix["sessions"]
    if mix["kind"] == "search":
        words = gen_search.vocabulary(mix["vocabulary"])
        return [_text_session(mix, words, _rng(seed, s)) for s in range(n)]
    order = list(range(mix["pool"]))
    random.Random(seed).shuffle(order)
    return [_photo_session(mix, [order[(s + k * n) % len(order)] for k in range(len(order))], _rng(seed, s))
            for s in range(n)]


def check_caps(mix: dict) -> dict:
    """The check's sample as the open loop's ``check_sample`` draws it, bucket
    by bucket, from the requests answered in the window. Text: n / 2 new
    queries drawn from the seed, the n / 4 refinements with the most marks
    and the longest texts, and others drawn from the seed. Photos: n / 2 new
    uploads drawn from the seed and the refinements with the most marks."""
    n = mix["check_requests"]
    if mix["kind"] == "search":
        return {"new": n // 2, "costly": n // 4, "other": n - n // 2 - n // 4}
    return {"new": n // 2, "costly": n - n // 2}


def _rng(seed: int, session: int) -> random.Random:
    return random.Random(seed * 65_537 + session)


def _block_kinds(mix: dict, rng: random.Random, first: bool) -> list:
    """One block's kinds in ``rng``'s order; a session's first block starts
    with a new request (there is no answer to refine yet)."""
    n_new = round(mix["new_share"] * BLOCK)
    kinds = ["new"] * n_new + ["refine"] * (BLOCK - n_new)
    rng.shuffle(kinds)
    if first and "new" in kinds:
        j = kinds.index("new")
        kinds[0], kinds[j] = kinds[j], kinds[0]
    return kinds


def _text_session(mix: dict, words: list, rng: random.Random):
    q = None
    for b in itertools.count():
        kinds = _block_kinds(mix, rng, b == 0)
        n_words = gen_search._cycle(*mix["words"], BLOCK, rng)
        n_marks = gen_search._cycle(*mix["marks"], BLOCK, rng)
        for kind, nw, nm in zip(kinds, n_words, n_marks):
            h = rng.random()
            if kind == "new":
                q = " ".join(rng.choice(words) for _ in range(nw))
                yield {"q": q, "kind": kind, "ranks": [], "pick": [("new", (h,))]}
            else:
                ranks = rng.sample(range(mix["mark_from_top"]), nm)
                yield {"q": q, "kind": kind, "ranks": ranks,
                       "pick": [("costly", (-nm, -len(q), h)), ("other", (h,))]}


def _photo_session(mix: dict, photos: list, rng: random.Random):
    uploads, photo = 0, None
    for b in itertools.count():
        kinds = _block_kinds(mix, rng, b == 0)
        n_marks = gen_search._cycle(*mix["marks"], BLOCK, rng)
        for kind, nm in zip(kinds, n_marks):
            h = rng.random()
            if kind == "new":
                photo, uploads = photos[uploads % len(photos)], uploads + 1
                yield {"photo": photo, "kind": kind, "ranks": [], "pick": [("new", (h,))]}
            else:
                yield {"photo": photo, "kind": kind, "ranks": rng.sample(range(mix["mark_from_top"]), nm),
                       "pick": [("costly", (-nm, h))]}
