"""Load a running serving host (``python -m tpurec_torch.server``, or
tpurec's, which answers the same routes) with concurrent clients: the
port's client side of ``scripts/bench_serve_latency.py``.

Each client is a thread that POSTs ``/predict`` requests in turn, on its
own keep-alive connection (``http.client``; :func:`run_cell` can also open
a new connection every request through ``urllib``, as a client library
without keep-alive does).  Each client sends WARM requests first, untimed;
then the cell's requests, shared evenly by its clients, are timed on the
host clock from the send to the parsed reply.

    python scripts/serve_load.py --url http://127.0.0.1:8080 \\
        --rows 1 512 4096 --clients 1 4 16 --requests 128

prints one JSON line per (rows, clients) cell: p50 and p99 ms, requests/s
and rows/s (requests and rows over the wall time of the timed part).  Ids
are drawn from ``--seed`` under ``--field_dims`` (default: the flagship's
23 Ali-CCP-shaped fields).  Imports neither JAX nor torch.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
import urllib.parse
import urllib.request
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

FIELD_DIMS = (
    250000, 10, 10, 10, 10, 10, 10, 10, 10,
    1368287,
    50,
    5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4,
)

WARM = 2                        # untimed requests a client sends first
Request = Tuple[bytes, int]     # (JSON body, rows)


def make_rows(field_dims: Sequence[int], n: int,
              rng: np.random.Generator) -> np.ndarray:
    """[n, F] int64 ids, each field's uniform over its vocabulary."""
    return np.stack([rng.integers(0, d, n) for d in field_dims], axis=1)


def body_of(rows: np.ndarray) -> bytes:
    return json.dumps({"instances": rows.tolist()}).encode()


class _Keepalive:
    """One persistent connection."""

    def __init__(self, url):
        u = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(u.hostname, u.port,
                                               timeout=600)

    def post(self, body: bytes) -> dict:
        self.conn.request("POST", "/predict", body,
                          {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        data = r.read()
        if r.status != 200:
            raise RuntimeError(f"/predict {r.status}: {data[:200]!r}")
        return json.loads(data)

    def close(self):
        self.conn.close()


class _NewConnection:
    """A new connection every request (urllib closes it after the reply)."""

    def __init__(self, url):
        self.url = url.rstrip("/") + "/predict"

    def post(self, body: bytes) -> dict:
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def close(self):
        pass


def run_cell(url: str, requests_of: Callable[[int], List[Request]],
             clients: int, n_requests: Optional[int] = None,
             seconds: Optional[float] = None, keepalive: bool = True,
             warm: int = 0, before: Optional[Callable[[], None]] = None,
             on_reply: Optional[Callable[[int, int, dict], None]] = None
             ) -> dict:
    """``clients`` threads send client i's requests ``requests_of(i)`` in
    turn: ``n_requests`` in all (shared evenly, the first clients taking
    the remainder) or until ``seconds`` have passed.  Each first sends
    ``warm`` untimed requests; ``before()`` runs once every client is
    warm, before the timed part starts.  ``on_reply(i, j, reply)`` sees
    each timed reply to client i's j-th request (its index in
    ``requests_of(i)``) and may raise; a client's exception is raised
    here.  -> {"latency_ms": [(rows, ms), ...], "wall_s": the timed
    part's wall time, "requests", "rows"}."""
    if (n_requests is None) == (seconds is None):
        raise ValueError("give n_requests or seconds")
    conn_cls = _Keepalive if keepalive else _NewConnection
    ready = threading.Barrier(clients + 1)
    go = threading.Barrier(clients + 1)
    lat: List[List[Tuple[int, float]]] = [[] for _ in range(clients)]
    errors: List[BaseException] = []
    state = {"deadline": None}

    def count(i):
        if n_requests is None:
            return None
        return n_requests // clients + (i < n_requests % clients)

    def client(i):
        conn = None
        try:
            reqs = requests_of(i)
            conn = conn_cls(url)
            for k in range(warm):
                conn.post(reqs[k % len(reqs)][0])
        except BaseException as e:      # re-raised in the caller
            errors.append(e)
        try:
            ready.wait()
            go.wait()
        except threading.BrokenBarrierError:
            errors.append(RuntimeError("the cell was called off"))
        if errors:
            if conn is not None:
                conn.close()
            return
        try:
            n = count(i)
            k = 0
            while (k < n) if n is not None else (
                    time.perf_counter() < state["deadline"]):
                j = k % len(reqs)
                body, rows = reqs[j]
                t0 = time.perf_counter()
                reply = conn.post(body)
                lat[i].append((rows, (time.perf_counter() - t0) * 1e3))
                if on_reply is not None:
                    on_reply(i, j, reply)
                k += 1
        except BaseException as e:      # re-raised in the caller
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    try:
        if before is not None and not errors:
            before()
    except BaseException:
        go.abort()
        for t in threads:
            t.join()
        raise
    t0 = time.perf_counter()
    if seconds is not None:
        state["deadline"] = t0 + seconds
    go.wait()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    flat = [x for per in lat for x in per]
    return {"latency_ms": flat, "wall_s": wall, "requests": len(flat),
            "rows": sum(r for r, _ in flat)}


def summary(cell: dict, rows: Optional[int] = None) -> dict:
    """p50 / p99 ms (of the requests of ``rows`` rows, or all), requests/s
    and rows/s over the cell's wall time."""
    ms = [m for r, m in cell["latency_ms"] if rows is None or r == rows]
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "requests": len(ms),
            "requests_per_s": cell["requests"] / cell["wall_s"],
            "rows_per_s": cell["rows"] / cell["wall_s"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--url", required=True,
                    help="the host's base URL, http://HOST:PORT")
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 512, 4096])
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--requests", type=int, default=128,
                    help="timed requests a cell, shared by its clients")
    ap.add_argument("--field_dims", default=None,
                    help="comma-separated vocabulary sizes (default: the "
                    "flagship's 23 fields)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dims = (tuple(int(d) for d in args.field_dims.split(","))
            if args.field_dims else FIELD_DIMS)
    rng = np.random.default_rng(args.seed)
    for n in args.rows:
        bodies = [body_of(make_rows(dims, n, rng))
                  for _ in range(max(args.clients))]
        for c in args.clients:
            cell = run_cell(args.url, lambda i: [(bodies[i], n)], c,
                            n_requests=args.requests, warm=WARM)
            print(json.dumps({"metric": "serve_load", "url": args.url,
                              "rows": n, "clients": c, **summary(cell)}),
                  flush=True)


if __name__ == "__main__":
    main()
