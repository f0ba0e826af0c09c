"""The search traffic of a cell, made from its mix and ``--seed`` alone.

Open loop: every request has a due time fixed before the run. The gaps
between due times, the word counts of new queries, the marks of refinements
and the new/refine split are each one fixed multiset (drawn from a constant
stream), put in another order by the seed: every seed gives the same amount
of work, so seeds differ in order and content only. Bursts (``burst``:
``factor`` times the rate for ``length_s`` of every ``period_s``) warp the
same unit-rate gaps onto the bursty rate.

A request is a new query (a new session: 3-12 words from a seeded
vocabulary) or a refinement of a session whose last request was due
``think_s`` ago: the same text (a text-cache hit) with 1-5 results of that
session's last answer marked (Rocchio). The warm-up phase (``warmup_s``
before the window) opens the sessions the window's first refinements need.
"""

from __future__ import annotations

import bisect
import random

FIXED = 0x5EA2C4  # the constant stream every multiset is drawn from


def vocabulary(size: int) -> list:
    rng = random.Random(FIXED)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words, seen = [], set()
    while len(words) < size:
        w = "".join(rng.choice(letters) for _ in range(rng.randint(3, 9)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _rate_at(mix: dict, t: float) -> float:
    rate = mix["rate_per_s"]
    b = mix.get("burst")
    if b and (t % b["period_s"]) < b["length_s"]:
        return rate * b["factor"]
    return rate


def _expected(mix: dict, seconds: float, step: float = 1e-3) -> float:
    n, t = 0.0, 0.0
    while t < seconds:
        n += _rate_at(mix, t) * min(step, seconds - t)
        t += step
    return n


def _warp(mix: dict, units, seconds: float, step: float = 1e-3) -> list:
    """Cumulative unit-rate arrival marks -> due times under the mix's rate."""
    out, t, acc, i = [], 0.0, 0.0, 0
    marks = sorted(units)
    while i < len(marks) and t < seconds:
        r = _rate_at(mix, t)
        nxt = acc + r * step
        while i < len(marks) and marks[i] <= nxt:
            out.append(t + (marks[i] - acc) / r)
            i += 1
        acc, t = nxt, t + step
    return out


def _arrivals(mix: dict, seconds: float, rng: random.Random) -> list:
    """Due times in [0, seconds): a fixed multiset of exponential gaps,
    scaled to the phase's expected count, in the seed's order."""
    n = max(1, round(_expected(mix, seconds)))
    fixed = random.Random(FIXED + n)
    gaps = [fixed.expovariate(1.0) for _ in range(n)]
    rng.shuffle(gaps)
    scale = n / (sum(gaps) * (1 + 1 / n))
    marks, acc = [], 0.0
    for g in gaps:
        acc += g * scale
        marks.append(acc)
    return _warp(mix, marks, seconds)


def _cycle(lo: int, hi: int, n: int, rng: random.Random) -> list:
    vals = [lo + i % (hi - lo + 1) for i in range(n)]
    rng.shuffle(vals)
    return vals


def schedule(mix: dict, seed: int, seconds: float) -> list:
    """[{"at", "q", "prev", "ranks", "window", "kind"}]: ``at`` the due time
    in seconds from the window's start (negative in the warm-up), ``prev``
    the index of the session's previous request for a refinement (-1 for a
    new query), ``ranks`` the marked result ranks."""
    rng = random.Random(seed)
    words = vocabulary(mix["vocabulary"])
    warm = mix["warmup_s"]
    times = [(t - warm, False) for t in _arrivals(mix, warm, rng)]
    times += [(t, True) for t in _arrivals(mix, seconds, rng)]
    n = len(times)
    n_new = round(mix["new_share"] * n)
    kinds = ["new"] * n_new + ["refine"] * (n - n_new)
    rng.shuffle(kinds)
    wlo, whi = mix["words"]
    mlo, mhi = mix["marks"]
    n_words = _cycle(wlo, whi, n, rng)
    n_marks = _cycle(mlo, mhi, n, rng)
    tmin, tmax = mix["think_s"]
    out, last = [], {}  # session -> (its last request's index, due time)
    hist_t, hist_s = [], []  # every request's due time and session, in order
    for i, ((at, in_window), kind) in enumerate(zip(times, kinds)):
        cands = []
        if kind == "refine":
            lo, hi = bisect.bisect_left(hist_t, at - tmax), bisect.bisect_right(hist_t, at - tmin)
            cands = [hist_s[j] for j in range(lo, hi) if last[hist_s[j]][1] == hist_t[j]]
        if cands:
            s = rng.choice(cands)
            prev = last[s][0]
            q = out[prev]["q"]
            ranks = rng.sample(range(mix["mark_from_top"]), n_marks[i])
        else:
            kind, s, prev, ranks = "new", i, -1, []
            q = " ".join(rng.choice(words) for _ in range(n_words[i]))
        last[s] = (i, at)
        hist_t.append(at)
        hist_s.append(s)
        out.append({"at": at, "q": q, "prev": prev, "ranks": ranks, "window": in_window, "kind": kind})
    return out


def check_sample(reqs: list, seed: int, n: int) -> list:
    """Indices of window requests whose answers the reference checks: half
    new queries, half refinements, the refinements with the most marks and
    the longest texts first among them (the costliest Rocchio queries)."""
    rng = random.Random(seed ^ 0xC4EC)
    new = [i for i, r in enumerate(reqs) if r["window"] and r["kind"] == "new"]
    ref = [i for i, r in enumerate(reqs) if r["window"] and r["kind"] == "refine"]
    longest = sorted(ref, key=lambda i: (-len(reqs[i]["ranks"]), -len(reqs[i]["q"]), i))[: n // 4]
    rest = [i for i in ref if i not in set(longest)]
    picked = rng.sample(new, min(len(new), n // 2)) + longest
    picked += rng.sample(rest, min(len(rest), n - len(picked)))
    return sorted(picked)
