"""Closed-loop HTTP load for ``POST /search`` or ``POST /search_image``, in a
process of its own.

Run by the drivers as ``python3 bench_port/loadgen_closed.py IN OUT``: IN is
a JSON file with the server's port, the window's start ``t0`` (a
``time.monotonic()`` reading: one clock for every process on the host), its
``seconds``, ``k``, the mix (its ``kind`` names the route) and seed, the
check sample's buckets (``keep``) and, for uploads, the pool's JPEG paths.
Each session (``gen_sessions.sessions``) sends its next request the moment
its previous answer arrives, from the warm-up's start until the window
closes; a request is due when it is sent. OUT receives, for every request
sent, when it was sent and answered and its status, the requests, the bodies
of those the check samples (``_Sample``, drawn as answers arrive) with the
marks they sent, and the client's own load over the window: its CPU seconds
and the event loop's lag (``_Client``), to tell whether this process sets
the pace. One thread, asyncio, keep-alive connections, the open-loop
generators' requests; imports nothing of torch.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import gen_sessions, loadgen, loadgen_photo  # noqa: E402

TICK_S = 0.01  # the lag probe's period


class _Sample:
    """The answers the reference checks, chosen as they arrive from the
    window's answered requests: bucket b holds the ``caps[b]`` smallest keys
    offered to it, and a request it refuses or pushes out is offered to the
    next bucket its ``pick`` names. So each bucket ends with its smallest
    keys among the requests that no earlier bucket kept, as a choice made
    after the window would, while only the held bodies are kept."""

    def __init__(self, caps: dict):
        self.caps = caps
        self.held = {b: [] for b in caps}  # sorted (key, index, level)
        self.items: dict = {}  # index -> (pick, data)

    def offer(self, i: int, pick, data) -> None:
        self.items[i] = (pick, data)
        level = 0
        while level < len(pick):
            bucket, key = pick[level]
            held = self.held[bucket]
            bisect.insort(held, (tuple(key), i, level))
            if len(held) <= self.caps[bucket]:
                return
            _, i, level = held.pop()
            pick, level = self.items[i][0], level + 1
        del self.items[i]

    def kept(self) -> dict:
        return {i: self.items[i][1] for held in self.held.values() for _, i, _ in held}


class _Client:
    """This process's own load over the window: CPU seconds (user and
    system, ``os.times``) and how late a ``TICK_S`` sleep of the event loop
    wakes, each tick's lag in ms."""

    def __init__(self):
        self.cpu_s, self.lag_ms = None, []

    async def probe(self, t0: float, close: float) -> None:
        await asyncio.sleep(max(0.0, t0 - time.monotonic()))
        cpu0 = _cpu_s()
        while (t := time.monotonic()) < close:
            await asyncio.sleep(TICK_S)
            self.lag_ms.append((time.monotonic() - t - TICK_S) * 1e3)
        self.cpu_s = _cpu_s() - cpu0

    def record(self, seconds: float) -> dict:
        lag = sorted(self.lag_ms)
        pick = (lambda q: lag[min(len(lag) - 1, int(q * len(lag)))]) if lag else (lambda q: None)
        return {"cpu_s": self.cpu_s, "seconds": seconds, "ticks": len(lag),
                "lag_ms": {"p50": pick(0.5), "p99": pick(0.99), "max": lag[-1] if lag else None}}


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


async def run(spec: dict, plans: list, post) -> dict:
    """``plans`` one iterator of requests a session, ``post(r, refs)`` sends
    one -> ``(status, body)``."""
    t0, close = spec["t0"], spec["t0"] + spec["seconds"]
    sample, client = _Sample(spec["keep"]), _Client()
    reqs, rows = [], []

    async def session(plan) -> None:
        body = None  # the session's previous answer, while it was a 200
        while time.monotonic() < close:
            r = next(plan)
            i = len(reqs)
            reqs.append(r)
            rows.append(None)
            refs = []
            if r["kind"] == "refine" and body is not None:
                images = json.loads(body)["images"]
                refs = [images[j]["image_path"] for j in r["ranks"] if j < len(images)]
            sent = time.monotonic()
            try:
                status, body = await post(r, refs)
            except Exception as err:  # a request that fails is recorded as failed
                status, body = -1, repr(err).encode()
            end = time.monotonic()
            rows[i] = [sent - t0, sent - t0, end - t0, status]
            if status != 200:
                body = None
            elif t0 <= end < close:
                sample.offer(i, r["pick"], (body, refs))

    await asyncio.sleep(max(0.0, t0 - spec["mix"]["warmup_s"] - time.monotonic()))
    probe = asyncio.ensure_future(client.probe(t0, close))
    tasks = [asyncio.ensure_future(session(p)) for p in plans]
    await asyncio.wait(tasks + [probe], timeout=max(0.0, close + loadgen.DRAIN_S - time.monotonic()))
    for t in tasks + [probe]:
        t.cancel()
    await asyncio.gather(*tasks, probe, return_exceptions=True)
    return {
        "rows": rows,
        "requests": [{key: v for key, v in r.items() if key != "pick"} for r in reqs],
        "kept": {str(i): {"body": body.decode(), "refs": refs} for i, (body, refs) in sample.kept().items()},
        "k": spec["k"],
        "client": client.record(spec["seconds"]),
    }


async def _main(spec: dict) -> dict:
    pool, k = loadgen._Pool(spec["port"]), spec["k"]
    if spec["mix"]["kind"] == "search":
        def post(r, refs):
            return loadgen._post(pool, "/search", json.dumps({"q": r["q"], "referenced_images": refs}).encode())
    else:
        photos = []
        for path in spec["photos"]:
            with open(path, "rb") as f:
                photos.append(f.read())

        def post(r, refs):
            return loadgen_photo._post(pool, loadgen_photo.target(k, refs), photos[r["photo"]])
    try:
        return await run(spec, gen_sessions.sessions(spec["mix"], spec["seed"]), post)
    finally:
        pool.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    out = asyncio.run(_main(spec))
    with open(argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
