"""The query-by-photo traffic of a cell, made from its mix and ``--seed`` alone.

The photos: a pool of ``pool`` distinct JPEGs, as a phone or a messenger
shares them (long side ``long_side`` px, a fixed spread of sizes between its
two ends, 4:3, ``portrait_share`` in portrait, quality ``jpeg_quality``),
their pixels made on the device by ``gen_photos.pixels`` from the seed.

The requests, open loop as ``gen_search.schedule`` makes them (the same
fixed multisets of gaps and marks in the seed's order): a request is a new
upload (a new session: the next photo of the pool in the seed's order) or a
refinement of a session whose last request was due ``think_s`` ago: the
same photo posted again with 1-5 results of that session's last answer
marked (Rocchio). The warm-up phase (``warmup_s`` before the window) opens
the sessions the window's first refinements need.
"""

from __future__ import annotations

import bisect
import random

from bench_port import gen_photos, gen_search


def shapes(mix: dict) -> list:
    """(h, w) of every pool photo: long sides spread evenly over the mix's
    range, short side 3/4 of it (even), a fixed share in portrait, spread
    over the sizes."""
    n, (lo, hi) = mix["pool"], mix["long_side"]
    n_portrait = round(mix["portrait_share"] * n)
    out = []
    for i in range(n):
        long = lo + (hi - lo) * i // max(1, n - 1)
        short = long * 3 // 4 // 2 * 2
        portrait = (i * n_portrait) % n < n_portrait  # spread evenly over the sizes
        out.append((long, short) if portrait else (short, long))
    return out


def write_pool(torch, mix: dict, seed: int, directory: str, device) -> list:
    """The pool's JPEG files -> their paths."""
    return gen_photos.write_pool(torch, seed, directory, shapes(mix), mix["grain"], mix["jpeg_quality"], device)


def schedule(mix: dict, seed: int, seconds: float) -> list:
    """[{"at", "photo", "prev", "ranks", "window", "kind"}]: ``at`` the due
    time in seconds from the window's start (negative in the warm-up),
    ``photo`` the pool index posted, ``prev`` the index of the session's
    previous request for a refinement (-1 for a new upload), ``ranks`` the
    marked result ranks."""
    rng = random.Random(seed)
    warm = mix["warmup_s"]
    times = [(t - warm, False) for t in gen_search._arrivals(mix, warm, rng)]
    times += [(t, True) for t in gen_search._arrivals(mix, seconds, rng)]
    n = len(times)
    n_new = round(mix["new_share"] * n)
    kinds = ["new"] * n_new + ["refine"] * (n - n_new)
    rng.shuffle(kinds)
    mlo, mhi = mix["marks"]
    n_marks = gen_search._cycle(mlo, mhi, n, rng)
    order = list(range(mix["pool"]))
    rng.shuffle(order)
    tmin, tmax = mix["think_s"]
    out, last, uploads = [], {}, 0  # last: session -> (its last request's index, due time)
    hist_t, hist_s = [], []
    for i, ((at, in_window), kind) in enumerate(zip(times, kinds)):
        cands = []
        if kind == "refine":
            lo, hi = bisect.bisect_left(hist_t, at - tmax), bisect.bisect_right(hist_t, at - tmin)
            cands = [hist_s[j] for j in range(lo, hi) if last[hist_s[j]][1] == hist_t[j]]
        if cands:
            s = rng.choice(cands)
            prev = last[s][0]
            photo = out[prev]["photo"]
            ranks = rng.sample(range(mix["mark_from_top"]), n_marks[i])
        else:
            kind, s, prev, ranks = "new", i, -1, []
            photo = order[uploads % len(order)]
            uploads += 1
        last[s] = (i, at)
        hist_t.append(at)
        hist_s.append(s)
        out.append({"at": at, "photo": photo, "prev": prev, "ranks": ranks, "window": in_window, "kind": kind})
    return out


def check_sample(reqs: list, seed: int, n: int) -> list:
    """Indices of window requests whose answers the reference checks: n / 2
    new uploads drawn from the seed, and the n / 2 refinements with the most
    marks (the costliest Rocchio queries)."""
    rng = random.Random(seed ^ 0xC4EC)
    new = [i for i, r in enumerate(reqs) if r["window"] and r["kind"] == "new"]
    ref = [i for i, r in enumerate(reqs) if r["window"] and r["kind"] == "refine"]
    most = sorted(ref, key=lambda i: (-len(reqs[i]["ranks"]), i))[: n - n // 2]
    return sorted(rng.sample(new, min(len(new), n // 2)) + most)
