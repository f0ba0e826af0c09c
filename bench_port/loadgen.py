"""Open-loop HTTP load for ``POST /search``, in a process of its own.

Run by the search driver as ``python3 bench_port/loadgen.py IN OUT``: IN is
a JSON file with the server's port, the window's start ``t0`` (a
``time.monotonic()`` reading: one clock for every process on the host) and
the schedule (``gen_search.schedule``); OUT receives, for every request,
when it was due, sent and answered, and its status, plus the bodies of the
requests the reference checks. One thread, asyncio, keep-alive connections:
a request is sent at its due time whatever the earlier ones are doing, so
the server's queue can grow. A refinement waits for its session's last
answer (it marks results from it); its latency still counts from its own
due time. Imports nothing of torch.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

DRAIN_S = 60.0  # how long past the window's close an answer is waited for


class _Pool:
    def __init__(self, port: int):
        self.port = port
        self.idle: list = []

    async def get(self):
        if self.idle:
            return self.idle.pop()
        return await asyncio.open_connection("127.0.0.1", self.port)

    def put(self, conn) -> None:
        self.idle.append(conn)

    def close(self) -> None:
        for _, w in self.idle:
            w.close()


async def _post(pool: _Pool, path: str, payload: bytes):
    reader, writer = conn = await pool.get()
    try:
        writer.write(b"POST %s HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (path.encode(), len(payload), payload))
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


async def _run(spec: dict) -> dict:
    reqs, keep = spec["requests"], set(spec["keep"])
    t0, k = spec["t0"], spec["k"]
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
            payload = json.dumps({"q": r["q"], "referenced_images": refs}).encode()
            status, body = await _post(pool, "/search", payload)
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
