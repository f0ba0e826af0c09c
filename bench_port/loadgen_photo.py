"""Open-loop HTTP load for ``POST /search_image``, in a process of its own.

Run by the query-by-photo driver as ``python3 bench_port/loadgen_photo.py IN
OUT``: IN is a JSON file with the server's port, the window's start ``t0``
(a ``time.monotonic()`` reading), ``k``, the pool's JPEG paths and the
schedule (``gen_photo_query.schedule``); OUT receives, for every request,
when it was due, sent and answered, and its status, plus the bodies of the
requests the reference checks and the marks they sent. Each request posts
its photo's raw bytes to ``/search_image?k=K``, a refinement with a
``ref=`` for each result it marks in its session's last answer (it waits
for that answer; its latency still counts from its own due time). The photos are
read into memory before the first request. As ``loadgen.py``: one thread,
asyncio, keep-alive connections; imports nothing of torch.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
import urllib.parse

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.loadgen import DRAIN_S, _Pool  # noqa: E402


async def _post(pool: _Pool, path: str, payload: bytes):
    reader, writer = conn = await pool.get()
    try:
        writer.write(b"POST %s HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/octet-stream\r\n"
                     b"Content-Length: %d\r\n\r\n" % (path.encode(), len(payload)) + payload)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split()[1])
        length, close = 0, False
        for line in lines[1:]:
            key, _, val = line.partition(":")
            if key.lower() == "content-length":
                length = int(val)
            elif key.lower() == "connection" and val.strip().lower() == "close":
                close = True
        body = await reader.readexactly(length)
    except BaseException:
        writer.close()
        raise
    if close:
        writer.close()
    else:
        pool.put(conn)
    return status, body


def target(k: int, refs: list) -> str:
    """The request's path and query: ``/search_image?k=K&ref=...``."""
    return "/search_image?" + urllib.parse.urlencode([("k", k)] + [("ref", r) for r in refs])


async def _run(spec: dict) -> dict:
    reqs, keep = spec["requests"], set(spec["keep"])
    t0, k = spec["t0"], spec["k"]
    photos = []
    for path in spec["photos"]:
        with open(path, "rb") as f:
            photos.append(f.read())
    needed = {r["prev"] for r in reqs if r["prev"] >= 0}
    pool = _Pool(spec["port"])
    done = [asyncio.Event() for _ in reqs]
    bodies: dict = {}
    rows = [None] * len(reqs)
    sent_refs: dict = {}

    async def one(i: int, r: dict) -> None:
        due = t0 + r["at"]
        await asyncio.sleep(max(0.0, due - time.monotonic()))
        refs = []
        try:
            if r["prev"] >= 0:
                await done[r["prev"]].wait()
                prev = bodies.get(r["prev"])
                images = json.loads(prev)["images"] if prev else []
                refs = [images[j]["image_path"] for j in r["ranks"] if j < len(images)]
            sent = time.monotonic()
            status, body = await _post(pool, target(k, refs), photos[r["photo"]])
        except Exception as err:  # a request that fails is recorded as failed
            sent, status, body = time.monotonic(), -1, repr(err).encode()
        end = time.monotonic()
        rows[i] = [r["at"], sent - t0, end - t0, status]
        if status == 200 and (i in needed or i in keep):
            bodies[i] = body
        if i in keep:
            sent_refs[i] = refs
        done[i].set()

    tasks = [asyncio.ensure_future(one(i, r)) for i, r in enumerate(reqs)]
    horizon = t0 + max(r["at"] for r in reqs) + DRAIN_S
    await asyncio.wait(tasks, timeout=max(0.0, horizon - time.monotonic()))
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    pool.close()
    return {
        "rows": rows,
        "kept": {str(i): {"body": bodies[i].decode() if i in bodies else None, "refs": sent_refs.get(i)}
                 for i in keep},
        "k": k,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    out = asyncio.run(_run(spec))
    with open(argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
