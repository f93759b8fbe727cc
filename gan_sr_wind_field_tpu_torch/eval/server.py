"""HTTP serving daemon with micro-batching, around ``eval/serve.py``.

The port's own copy of ``gan_sr_wind_field_tpu/eval/server.py``
(``MicroBatcher``, ``WindFieldServer``, ``serve``, ``tiled_upscale_via``;
stdlib ``http.server`` + ``threading`` + ``queue``). One dispatcher thread
owns all device work; same-shape requests that arrive within
``max_wait_ms`` of each other are stacked into one generator call, padded
to the next power of two. Every wait has a timeout (120 s by default).

Protocol (numpy ``.npz`` both directions):

    POST /v1/upscale            ``lr`` (x,y,zl,C) or (n,x,y,zl,C) and ``z``
                                (X,Y,zl,1) or (n,X,Y,zl,1), model space
                                -> 200, npz ``sr`` float32; 400 on a bad
                                payload or a z inconsistent with lr
    POST /v1/upscale_physical   ``lr_uvw`` in m/s and raw height ``z``
                                -> npz ``sr`` in m/s (needs norm_stats)
    POST /v1/upscale_tiled      ONE volume of any horizontal extent, tiled
                                server-side through the micro-batcher
    GET  /v1/health, /v1/stats  JSON

Serve a continuation pack, or a checkpoint of a port run, on the card:

    python -m gan_sr_wind_field_tpu_torch.eval.server \
        --cfg configs/milestone9k.ini \
        --continuation docs/evidence/milestone9k_continuation_9000.npz \
        --port 8000 --warmup 1,8
    python -m gan_sr_wind_field_tpu_torch.eval.server \
        --cfg <the run's config.ini> --checkpoint <the run>/ckpt_6016
    python -m gan_sr_wind_field_tpu_torch.eval.server \
        --cfg configs/fullvol8x3k.ini --checkpoint G_3000.pth

or an exported artifact (``eval/export.py``), with no config:

    python -m gan_sr_wind_field_tpu_torch.eval.server \
        --artifact generator.wsrx [--tile 16 --tile-overlap 4]
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_MAX_BODY = 1 << 30  # 1 GiB request cap


class _Job:
    __slots__ = ("lr", "z", "event", "result", "error", "t0")

    def __init__(self, lr: np.ndarray, z: np.ndarray):
        self.lr = lr
        self.z = z
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()  # enqueue time, for latency stats


class MicroBatcher:
    """Single-consumer request batcher in front of a ``.upscale`` backend.

    Submissions are (lr, z) single samples; the dispatcher thread stacks
    same-shape jobs (up to ``max_batch``, waiting at most ``max_wait_ms``
    after the first) into one batched ``backend.upscale`` call. With
    ``pad_pow2`` the stacked batch is padded to the next power of two by
    repeating the last sample, bounding the set of batch sizes.
    """

    def __init__(self, backend, max_batch: int = 128,
                 max_wait_ms: float = 5.0, pad_pow2: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.backend = backend
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.pad_pow2 = bool(pad_pow2)
        self._q: "queue.SimpleQueue[_Job]" = queue.SimpleQueue()
        self._stop = threading.Event()
        self.stats = {
            "requests": 0, "batches": 0, "batched_samples": 0,
            "padded_samples": 0, "max_batch_seen": 0, "errors": 0,
        }
        # bounded recent-window timings for the /v1/stats percentiles
        self._req_lat_s = collections.deque(maxlen=2048)  # enqueue -> done
        self._batch_s = collections.deque(maxlen=512)     # backend call
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="windsr-dispatch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, lr: np.ndarray, z: np.ndarray,
               timeout: float = 120.0) -> np.ndarray:
        """Blocking single-sample inference; raises the backend's error."""
        if lr.ndim != 4 or z.ndim != 4:
            raise ValueError(
                f"submit takes single samples: lr (x,y,zl,C) / z (X,Y,zl,1), "
                f"got lr.ndim={lr.ndim} z.ndim={z.ndim}"
            )
        return self.submit_many([lr], [z], timeout=timeout)[0]

    def submit_many(self, lrs, zs, timeout: float = 120.0) -> list:
        """Enqueue several samples at once (they micro-batch together and
        with anything else in flight), wait for all, return results."""
        jobs = [
            _Job(np.asarray(lr, np.float32), np.asarray(z, np.float32))
            for lr, z in zip(lrs, zs)
        ]
        with self._lock:
            self.stats["requests"] += len(jobs)
        for job in jobs:
            self._q.put(job)
        deadline = time.monotonic() + timeout
        for job in jobs:
            if not job.event.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError("inference did not complete in time")
        for job in jobs:
            if job.error is not None:
                raise job.error
        return [job.result for job in jobs]

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail anything still queued/parked so concurrent submitters get an
        # immediate error instead of blocking out their full timeout
        leftovers = []
        pending = getattr(self, "_pending", None)
        if pending is not None:
            leftovers.append(pending)
            self._pending = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for job in leftovers:
            job.error = RuntimeError("server shutting down")
            job.event.set()

    # ------------------------------------------------------------ dispatcher
    def _collect(self, first: _Job) -> list:
        """first + whatever same-shape jobs arrive within the batch window.

        Jobs with a different geometry end the window (and lead the next
        batch) — requests of one shape never wait behind another shape's
        batch."""
        jobs = [first]
        key = (first.lr.shape, first.z.shape)
        deadline = time.monotonic() + self.max_wait
        while len(jobs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if (nxt.lr.shape, nxt.z.shape) != key:
                self._pending = nxt
                break
            jobs.append(nxt)
        return jobs

    def _run(self) -> None:
        self._pending: Optional[_Job] = None
        while not self._stop.is_set():
            job = self._pending
            self._pending = None
            if job is None:
                try:
                    job = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            self._process(self._collect(job))

    def _process(self, jobs: list) -> None:
        n = len(jobs)
        pad_to = n
        if self.pad_pow2 and n > 1:
            pad_to = 1 << (n - 1).bit_length()
        pad_to = min(pad_to, self.max_batch)
        t_call = time.monotonic()
        try:
            lr = np.stack([j.lr for j in jobs]
                          + [jobs[-1].lr] * (pad_to - n))
            z = np.stack([j.z for j in jobs]
                         + [jobs[-1].z] * (pad_to - n))
            out = np.asarray(self.backend.upscale(lr, z))
            for i, j in enumerate(jobs):
                j.result = out[i]
        except BaseException as e:  # propagate to every waiter
            for j in jobs:
                j.error = e
            with self._lock:
                self.stats["errors"] += 1
        finally:
            done = time.monotonic()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["batched_samples"] += n
                self.stats["padded_samples"] += pad_to - n
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], n
                )
                self._batch_s.append(done - t_call)
                for j in jobs:
                    self._req_lat_s.append(done - j.t0)
            for j in jobs:
                j.event.set()

    # ------------------------------------------------------------- stats
    def stats_snapshot(self) -> dict:
        """Counters + recent-window latency percentiles (ms). Cheap under
        the lock (copies only); percentile math happens outside it."""
        with self._lock:
            snap = dict(self.stats)
            lat = list(self._req_lat_s)
            bat = list(self._batch_s)

        def pct(xs):
            if not xs:
                return {"count": 0}
            q = np.percentile(np.asarray(xs) * 1e3, [50, 95, 99])
            return {
                "count": len(xs),
                "p50_ms": round(float(q[0]), 3),
                "p95_ms": round(float(q[1]), 3),
                "p99_ms": round(float(q[2]), 3),
                "mean_ms": round(float(np.mean(xs)) * 1e3, 3),
            }

        snap["request_latency"] = pct(lat)
        snap["batch_duration"] = pct(bat)
        return snap


def tiled_upscale_via(submit_many, lr, z, scale: int, tile: int = 64,
                      overlap: int = 16) -> np.ndarray:
    """Overlap-tiled SR of ONE arbitrary-extent volume, each tile routed
    through ``submit_many`` (the micro-batcher's list-in/list-out call) so
    tiles stack with everything else in flight; host-side raised-cosine
    seam blending.

    lr: (x, y, zl, C) model-space input; z: (x·s, y·s, zl, 1).
    ``tile``/``overlap`` in LR pixels. The tile size is NEVER adapted to
    the request: every tensor handed to ``submit_many`` is exactly
    (tile, tile, zl, C), so tiles of every request stack into the same
    batches. Volumes smaller
    than the tile in either dim are edge-padded up to it and the output
    is cropped back.
    """
    tile = int(tile)
    if not 0 <= overlap < tile:
        raise ValueError(f"overlap must be in [0, tile); got {overlap} "
                         f"with tile {tile}")
    s = int(scale)
    X, Y = lr.shape[0], lr.shape[1]
    pad_x, pad_y = max(0, tile - X), max(0, tile - Y)
    if pad_x or pad_y:
        lr = np.pad(lr, ((0, pad_x), (0, pad_y), (0, 0), (0, 0)),
                    mode="edge")
        z = np.pad(z, ((0, pad_x * s), (0, pad_y * s), (0, 0), (0, 0)),
                   mode="edge")
    Xp, Yp = lr.shape[0], lr.shape[1]
    if Xp <= tile and Yp <= tile:
        sr = np.asarray(submit_many([lr], [z])[0])
        return sr[: X * s, : Y * s]
    step = tile - overlap
    xs = sorted({min(x0, Xp - tile) for x0 in range(0, Xp, step)})
    ys = sorted({min(y0, Yp - tile) for y0 in range(0, Yp, step)})
    coords = [(x0, y0) for x0 in xs for y0 in ys]
    srs = submit_many(
        [lr[x0:x0 + tile, y0:y0 + tile] for x0, y0 in coords],
        [z[x0 * s:(x0 + tile) * s, y0 * s:(y0 + tile) * s]
         for x0, y0 in coords],
    )
    # raised-cosine profile, 1.0 mid-tile (same form as serve.py)
    t = (np.arange(tile * s) + 0.5) / (tile * s)
    win1d = 0.5 - 0.5 * np.cos(2 * np.pi * t)
    win = np.outer(win1d, win1d)[:, :, None, None].astype(np.float32)
    out = np.zeros((Xp * s, Yp * s, lr.shape[2], 3), np.float32)
    weight = np.zeros((Xp * s, Yp * s, 1, 1), np.float32)
    for (x0, y0), sr_t in zip(coords, srs):
        sl = np.s_[x0 * s:(x0 + tile) * s, y0 * s:(y0 + tile) * s]
        out[sl] += np.asarray(sr_t) * win
        weight[sl] += win
    return (out / np.maximum(weight, 1e-12))[: X * s, : Y * s]


# ---------------------------------------------------------------- HTTP tier
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through the server's logger
        log = getattr(self.server, "log", None)
        if log is not None:
            log.info("%s %s" % (self.address_string(), fmt % args))

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:  # advertise it, don't just FIN
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server
        if self.path == "/v1/health":
            self._json(200, {
                "status": "ok",
                "scale": srv.meta.get("scale"),
                "backend": srv.meta.get("backend"),
                "norm_stats": srv.meta.get("norm_stats"),
                "lr_channels": srv.meta.get("lr_channels"),
                "tile": srv.meta.get("tile"),
                "tile_overlap": srv.meta.get("tile_overlap"),
                "allowed_shapes": srv.meta.get("allowed_shapes"),
            })
        elif self.path == "/v1/stats":
            # snapshot under the lock, write OUTSIDE it: a slow client must
            # never block the dispatcher (which takes this lock per batch)
            self._json(200, srv.batcher.stats_snapshot())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _physical_inputs(self, npz):
        """npz {lr_uvw, z[, pressure, z_above_ground]} in physical units →
        normalized model inputs via the server's norm_stats + channel
        layout (data/transform.py)."""
        from gan_sr_wind_field_tpu_torch.data.transform import (
            physical_to_model_inputs,
        )

        meta = self.server.meta
        stats, names = meta.get("norm_stats"), meta.get("lr_channels")
        if stats is None or names is None:
            raise ValueError(
                "server has no norm_stats/lr_channels — physical-units "
                "serving unavailable (serve from a checkpoint/artifact "
                "that carries them)"
            )
        opt = {
            k: np.asarray(npz[k], np.float32)
            for k in ("pressure", "z_above_ground") if k in npz.files
        }
        return physical_to_model_inputs(
            np.asarray(npz["lr_uvw"], np.float32),
            np.asarray(npz["z"], np.float32), stats, meta["scale"],
            include_pressure="p" in names,
            include_z_channel=("z" in names or "z_relative" in names),
            include_above_ground_channel="z_above_ground" in names,
            **opt,
        )

    def do_POST(self):
        # until the body has been fully read, error responses must close
        # the connection — an unread body would desync HTTP/1.1 keep-alive
        # (the next "request line" would be body bytes)
        tiled = self.path == "/v1/upscale_tiled"
        physical = self.path == "/v1/upscale_physical"
        if self.path != "/v1/upscale" and not physical and not tiled:
            self.close_connection = True
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        body_read = False
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            body = self.rfile.read(length)
            body_read = True
            overlap = self.server.meta.get("tile_overlap", 16)
            with np.load(io.BytesIO(body), allow_pickle=False) as npz:
                if tiled:
                    physical = "lr_uvw" in npz.files
                    if "overlap" in npz.files:
                        overlap = int(npz["overlap"])
                if physical:
                    lr, z = self._physical_inputs(npz)
                else:
                    lr = np.asarray(npz["lr"], np.float32)
                    z = np.asarray(npz["z"], np.float32)
            if tiled:
                if lr.ndim != 4 or z.ndim != 4:
                    raise ValueError(
                        f"/v1/upscale_tiled takes ONE volume (x,y,zl,C)/"
                        f"(X,Y,zl,1); got {lr.shape} / {z.shape}"
                    )
            else:
                squeeze = lr.ndim == 4
                if squeeze:
                    lr, z = lr[None], z[None]
                if lr.ndim != 5 or z.ndim != 5 or lr.shape[0] != z.shape[0]:
                    raise ValueError(
                        f"lr/z must be (x,y,zl,C)/(X,Y,zl,1) or batched; "
                        f"got {lr.shape} / {z.shape}"
                    )
            # z geometry is fully determined by lr + the server scale —
            # reject mismatches here (-> 400) instead of letting the
            # backend trace error surface as an opaque 500. This also
            # makes --serve_strict_shapes pin the z shape: allowed lr
            # shapes + this consistency check leave exactly one z shape.
            scale = self.server.meta.get("scale")
            x, y, zl, _ = lr.shape[-4:]
            zx, zy, zzl, zc = z.shape[-4:]
            if zc != 1 or zzl != zl or (
                scale and (zx != x * scale or zy != y * scale)
            ):
                raise ValueError(
                    f"z sample shape {(zx, zy, zzl, zc)} inconsistent "
                    f"with lr {(x, y, zl)} at scale {scale}: expected "
                    f"({x * scale if scale else 'x*s'}, "
                    f"{y * scale if scale else 'y*s'}, {zl}, 1)"
                )
        except Exception as e:
            if not body_read:
                self.close_connection = True
            self._json(400, {"error": str(e)})
            return
        try:
            if tiled:
                # tile size stays server-side; the tiles join the shared
                # dispatcher stream
                sr = tiled_upscale_via(
                    self.server.batcher.submit_many, lr, z,
                    self.server.meta["scale"],
                    tile=self.server.meta.get("tile", 64), overlap=overlap,
                )
                squeeze = True
                sr = sr[None]
            else:
                allowed = self.server.meta.get("allowed_shapes")
                if (allowed is not None
                        and tuple(lr.shape[1:]) not in allowed):
                    raise ValueError(
                        f"lr sample shape {tuple(lr.shape[1:])} not "
                        f"served: this deployment pins input shapes to "
                        f"{allowed} (use /v1/upscale_tiled for other "
                        f"extents)"
                    )
                # batched client requests split into jobs so they
                # micro-batch with everything else in flight (same shape
                # key -> same call)
                outs = self.server.batcher.submit_many(list(lr), list(z))
                sr = np.stack(outs)
            if physical:  # back to m/s
                from gan_sr_wind_field_tpu_torch.data.transform import _stat

                sr = sr * _stat(self.server.meta["norm_stats"], "uvw_max")
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        except Exception as e:
            self._json(500, {"error": str(e)})
            return
        buf = io.BytesIO()
        np.savez(buf, sr=sr[0] if squeeze else sr)
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class WindFieldServer(ThreadingHTTPServer):
    """HTTP server owning a MicroBatcher; see module docstring.

    ``allowed_shapes``: optional iterable of LR sample shapes
    (x, y, zl, C). When set, /v1/upscale[_physical] 400s any request
    whose lr sample shape is outside the set (strict-shape deployments);
    /v1/upscale_tiled stays exempt since it only submits the server
    tile shape. The pin is reported via /v1/health ``allowed_shapes``.
    The z shape needs no separate pin: every request's z geometry is
    validated against its lr + the server scale, which leaves exactly
    one admissible z shape per allowed lr shape.
    """

    daemon_threads = True

    def __init__(self, addr, backend, max_batch=128, max_wait_ms=5.0,
                 pad_pow2=True, log=None, tile=64, tile_overlap=16,
                 allowed_shapes=None):
        super().__init__(addr, _Handler)
        self.batcher = MicroBatcher(
            backend, max_batch=max_batch, max_wait_ms=max_wait_ms,
            pad_pow2=pad_pow2,
        )
        self.log = log
        stats = getattr(backend, "norm_stats", None)
        if stats is not None and not isinstance(stats, dict):
            import dataclasses

            if dataclasses.is_dataclass(stats):
                stats = dataclasses.asdict(stats)
        self.meta = {
            "scale": getattr(backend, "scale", None),
            "backend": type(backend).__name__,
            # model i/o is in NORMALIZED space; these factors (uvw_max …)
            # let clients recover physical units (data/transform.py)
            "norm_stats": stats,
            "lr_channels": getattr(backend, "lr_channels", None),
            # /v1/upscale_tiled geometry (LR pixels). Tile size is fixed
            # server-side so tiles batch together; overlap is
            # only a coordinate choice, so requests may override it. An
            # oversized default overlap degrades to the library tier's
            # 25% ratio (tile 64 / overlap 16) instead of 400-ing every
            # default-overlap request on small-tile deployments.
            "tile": int(tile),
            "tile_overlap": int(tile_overlap) if tile_overlap < tile
                            else max(int(tile) // 4, 0),
            # optional deployment pin: when set, /v1/upscale[_physical]
            # rejects LR sample shapes outside this set.
            # /v1/upscale_tiled is exempt — it only ever submits the
            # server-chosen tile shape.
            "allowed_shapes": (
                sorted({tuple(int(d) for d in s) for s in allowed_shapes})
                if allowed_shapes is not None else None
            ),
        }

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self.batcher.close()


def warmup(backend, lr_shape, z_shape, batch_sizes, log=None) -> None:
    """Run the serving forward once at each batch size before traffic
    arrives, so that no request pays for first-call set-up (cuDNN's
    algorithm search, the allocator's first blocks; the kernels were
    built when the backend was made). ``lr_shape``/``z_shape`` are
    single-sample shapes (x, y, zl, C) / (X, Y, zl, 1); zeros are enough."""
    for b in batch_sizes:
        t0 = time.monotonic()
        backend.upscale(
            np.zeros((int(b),) + tuple(lr_shape), np.float32),
            np.zeros((int(b),) + tuple(z_shape), np.float32),
        )
        if log is not None:
            log.info(f"warmup: batch {b} ran in "
                     f"{time.monotonic() - t0:.1f}s")


def serve(backend, host: str = "127.0.0.1", port: int = 0,
          max_batch: int = 128, max_wait_ms: float = 5.0,
          pad_pow2: bool = True, log=None,
          block: bool = False, tile: int = 64,
          tile_overlap: int = 16, allowed_shapes=None) -> WindFieldServer:
    """Start serving ``backend`` (WindFieldSR or ExportedSR).

    ``allowed_shapes`` (optional) pins /v1/upscale[_physical] to the
    given LR sample shapes — see `WindFieldServer`; ``tile``/
    ``tile_overlap`` set the /v1/upscale_tiled geometry.

    ``block=False`` runs the accept loop in a daemon thread and returns
    the server (``.server_address`` carries the bound port; ``.close()``
    stops it); ``block=True`` serves until interrupted — SIGTERM/SIGINT
    shut it down gracefully (in-flight batches finish, queued jobs get a
    shutdown error, the process exits cleanly — same preemption
    friendliness as the training loop's checkpoint handler).
    """
    srv = WindFieldServer(
        (host, port), backend, max_batch=max_batch,
        max_wait_ms=max_wait_ms, pad_pow2=pad_pow2, log=log,
        tile=tile, tile_overlap=tile_overlap,
        allowed_shapes=allowed_shapes,
    )
    if block:
        import signal

        def _graceful(signum, frame):
            if log is not None:
                log.info(f"signal {signum}: shutting down")
            # shutdown() deadlocks if called from serve_forever's own
            # thread (where this handler runs) — dispatch it
            threading.Thread(target=srv.shutdown, daemon=True).start()

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, _graceful)
        try:
            srv.serve_forever()
        finally:
            srv.close()
        return srv
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Serve a trained generator, or an exported artifact, "
                    "over HTTP"
    )
    p.add_argument("--cfg", default=None,
                   help="generator INI config (with --continuation or "
                        "--checkpoint)")
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("--continuation",
                         help="continuation pack (.npz) holding the weights")
    weights.add_argument("--checkpoint",
                         help="a port checkpoint folder (ckpt_{it}) of a "
                              "run of this configuration, or a reference "
                              "G_{it}.pth; a checkpoint's EMA slot is "
                              "preferred, as in the pack")
    weights.add_argument("--artifact",
                         help="a .wsrx file from run.py --export or "
                              "eval.interp, served with no config")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=128)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--warmup", metavar="B1,B2,...", default="",
                   help="run the forward at these batch sizes before "
                        "accepting traffic")
    p.add_argument("--tile", type=int, default=0,
                   help="/v1/upscale_tiled tile in LR pixels; default the "
                        "training patch (an artifact's static LR extent, "
                        "the only one it runs)")
    p.add_argument("--tile-overlap", type=int, default=None,
                   help="/v1/upscale_tiled overlap in LR pixels; default a "
                        "quarter of the tile")
    args = p.parse_args(argv)
    if (args.cfg is None) == (args.artifact is None):
        p.error("--artifact serves without --cfg; --continuation and "
                "--checkpoint need it")

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.export import load_exported
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

    weights = args.continuation or args.checkpoint or args.artifact
    if args.artifact:
        backend = load_exported(args.artifact, device=args.device)
        lr_shape = tuple(backend.header["lr_shape"][1:])
        z_shape = tuple(backend.header["z_shape"][1:])
    else:
        cfg = load_config(args.cfg)
        if args.continuation:
            backend = WindFieldSR.from_continuation(cfg, args.continuation,
                                                    device=args.device)
        else:
            # serving reads no coordinates: they feed the training losses
            coords = np.arange(cfg.gan_config.slice_size, dtype=np.float32)
            backend = WindFieldSR.from_checkpoint(
                cfg, args.checkpoint, coords, coords, device=args.device)
        g = cfg.gan_config
        lr_tile = (g.slice_size if g.enable_slicing else 64) // cfg.scale
        zl = g.number_of_z_layers
        lr_shape = (lr_tile, lr_tile, zl, cfg.lr_num_channels)
        z_shape = (lr_tile * cfg.scale, lr_tile * cfg.scale, zl, 1)
    tile = args.tile if args.tile > 0 else int(lr_shape[0])
    overlap = (args.tile_overlap if args.tile_overlap is not None
               else tile // 4)
    if args.warmup:
        import logging

        logging.basicConfig(level=logging.INFO)
        warmup(backend, lr_shape, z_shape,
               [int(b) for b in args.warmup.split(",")],
               log=logging.getLogger("windsr-serve"))
    print(f"serving {weights} (scale {backend.scale}) on "
          f"{args.host}:{args.port} ({backend.device}, tile {tile})",
          flush=True)
    serve(backend, host=args.host, port=args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
          block=True, tile=tile, tile_overlap=overlap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
