"""HTTP load of the serving cells, in a process of its own (numpy and the
standard library only: it never touches the card, and it does not share
the server's interpreter lock).

    python -m windbench.client '<json parameters>'

It makes its fields from the seed, encodes them, opens its connections,
prints ``ready`` and waits for ``go`` on its standard input. Then:

- ``open_loop``: request i is due at the i-th time of
  ``payloads.arrivals`` (one Poisson trace at ``rate``, entered where the
  seed says); a dispatcher hands each request at its due time to one of
  ``workers`` threads, each with a keep-alive connection, and its latency
  runs from when it was due to its whole response read. Every request due
  in the window is sent; the client then waits for each, up to
  ``drain_s`` past the close.
- ``closed_loop``: ``clients`` threads each post a field, wait for its
  reply and post the next, until the window closes; a reply counts if it
  arrived inside the window.

It writes one ``.npz`` to its standard output: per request its due time
(or send time), latency, whether it came back whole (status 200 and the
byte length of a reply of the right shape), how late the dispatcher ran,
and the replies of a sample drawn from the seed, decoded after the
window.
"""

from __future__ import annotations

import gc
import http.client
import io
import json
import queue
import sys
import threading
import time

import numpy as np

from windbench import payloads


def encode(lr: np.ndarray, z: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, lr=lr, z=z)
    return buf.getvalue()


def field_of(i: int, n_pool: int) -> int:
    """The pool field that request (or reply) number i carries."""
    return i % n_pool


class _Conn:
    def __init__(self, port: int, timeout: float):
        self.port, self.timeout = port, timeout
        self.c = None

    def open(self):
        """Connect now, so that the window pays for no connection, and wait
        for one reply on it: connecting many at once overflows the server's
        backlog of 5, and a connection refused that way is retried after a
        second."""
        self.c = http.client.HTTPConnection("127.0.0.1", self.port,
                                            timeout=self.timeout)
        self.c.request("GET", "/v1/health")
        r = self.c.getresponse()
        r.read()
        if r.status != 200:
            raise RuntimeError(f"the server answered {r.status}")

    def post(self, body: bytes):
        for attempt in (0, 1):
            try:
                if self.c is None:
                    self.open()
                self.c.request("POST", "/v1/upscale", body=body,
                               headers={"Content-Type":
                                        "application/octet-stream"})
                r = self.c.getresponse()
                data = r.read()
                return r.status, data
            except (ConnectionError, http.client.HTTPException, OSError):
                if self.c is not None:
                    self.c.close()
                self.c = None
                if attempt:
                    raise
        raise RuntimeError("unreachable")

    def close(self):
        if self.c is not None:
            self.c.close()


def reply_size(shape) -> int:
    """The byte length of the server's reply for one field of ``shape``."""
    buf = io.BytesIO()
    np.savez(buf, sr=np.zeros(shape, np.float32))
    return len(buf.getvalue())


def _decode(data: bytes, shape):
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            sr = np.asarray(z["sr"])
    except (ValueError, KeyError, OSError):
        return None
    return sr if sr.shape == tuple(shape) else None


def main(argv=None) -> int:
    p = json.loads((argv or sys.argv[1:])[0])
    nx, ny, nz, s = p["hr"][0], p["hr"][1], p["hr"][2], p["scale"]
    lrs, zs = payloads.pool(p["seed"], p["pool"], nx, ny, nz, s)
    bodies = [encode(lrs[i], zs[i]) for i in range(p["pool"])]
    out_shape = (nx, ny, nz, 3)
    timeout = float(p.get("timeout_s", 120.0))
    W = float(p["seconds"])
    mode = p["kind"]
    n_threads = int(p["workers"] if mode == "open_loop" else p["clients"])
    conns = [_Conn(p["port"], timeout) for _ in range(n_threads)]
    size = reply_size(out_shape)
    for c in conns:
        c.open()
    # inside the window the client only sends, reads and times: replies
    # are checked by status and length, the sampled ones decoded after it,
    # no collection pauses, and a short switch interval so that the
    # dispatcher wakes on time
    sys.setswitchinterval(5e-4)
    gc.collect()
    gc.disable()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 2
    t0 = time.perf_counter()
    if mode == "open_loop":
        res = _open_loop(p, bodies, conns, size, t0, W)
    else:
        res = _closed_loop(p, bodies, conns, size, t0, W)
    gc.enable()
    sr = [_decode(b, out_shape) for b in res.pop("replies")]
    if any(x is None for x in sr):  # a reply of the right length, unreadable
        res["sample_missing"] = np.int64(len(sr))
        res["sample_field"] = res["sample_field"][:0]
        sr = []
    res["sr"] = (np.stack(sr) if sr
                 else np.zeros((0,) + out_shape, np.float32))
    for c in conns:
        c.close()
    buf = io.BytesIO()
    np.savez(buf, **res)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.buffer.flush()
    return 0


def _open_loop(p, bodies, conns, size, t0, W):
    due = payloads.arrivals(p["seed"], p["rate"], W, p["trace_seed"])
    n = len(due)
    lat = np.full(n, np.inf)
    ok = np.zeros(n, bool)
    late = np.zeros(n)
    rng = np.random.default_rng([int(p["seed"]), 13])
    sample = np.sort(rng.choice(n, size=min(int(p["sample"]), n),
                                replace=False))
    keep = {int(i): None for i in sample}
    q: "queue.Queue" = queue.Queue()

    def worker(conn):
        while True:
            i = q.get()
            if i is None:
                return
            late[i] = time.perf_counter() - t0 - due[i]
            try:
                status, data = conn.post(bodies[field_of(i, len(bodies))])
            except (OSError, http.client.HTTPException, RuntimeError):
                continue
            lat[i] = time.perf_counter() - t0 - due[i]
            ok[i] = status == 200 and len(data) == size
            if ok[i] and i in keep:
                keep[i] = data
            if not ok[i]:
                lat[i] = np.inf

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in conns]
    for t in threads:
        t.start()
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        q.put(i)
    for _ in threads:
        q.put(None)
    deadline = t0 + W + float(p["drain_s"])
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    ok = ok & np.isfinite(lat)
    got = [i for i in sample if keep[int(i)] is not None]
    return {"due": due, "lat": lat, "ok": ok, "late": late,
            "sample": np.asarray(got, np.int64),
            "sample_field": np.asarray([field_of(i, len(bodies))
                                        for i in got], np.int64),
            "sample_missing": np.int64(len(sample) - len(got)),
            "replies": [keep[int(i)] for i in got]}


def _closed_loop(p, bodies, conns, size, t0, W):
    rows = []  # (client, j, start, end, ok)
    lock = threading.Lock()
    rng = np.random.default_rng([int(p["seed"]), 17])
    k = int(p["sample"])
    # reservoir sample of the replies that came back inside the window
    reservoir, seen = [], [0]

    def client(c, conn):
        j = 0
        while time.perf_counter() - t0 < W:
            f = field_of(c * 7919 + j, len(bodies))
            start = time.perf_counter() - t0
            try:
                status, data = conn.post(bodies[f])
            except (OSError, http.client.HTTPException, RuntimeError):
                status, data = 0, b""
            end = time.perf_counter() - t0
            ok = status == 200 and len(data) == size
            with lock:
                rows.append((c, j, start, end, ok))
                if ok and end <= W:
                    seen[0] += 1
                    if len(reservoir) < k:
                        reservoir.append((f, data))
                    else:
                        r = int(rng.integers(0, seen[0]))
                        if r < k:
                            reservoir[r] = (f, data)
            j += 1

    threads = [threading.Thread(target=client, args=(c, conn), daemon=True)
               for c, conn in enumerate(conns)]
    for t in threads:
        t.start()
    deadline = t0 + W + float(p["drain_s"])
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    arr = np.asarray([r[2:] for r in rows], np.float64).reshape(-1, 3)
    return {"start": arr[:, 0], "end": arr[:, 1], "ok": arr[:, 2] > 0,
            "sample_field": np.asarray([f for f, _ in reservoir], np.int64),
            "sample_missing": np.int64(0),
            "replies": [d for _, d in reservoir]}


if __name__ == "__main__":
    raise SystemExit(main())
