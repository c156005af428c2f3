"""HTTP serving host on top of :class:`tpurec_torch.serve.Predictor`
(counterpart of ``tpurec/server.py``, same routes and replies):

- ``POST /predict`` — body ``{"instances": [[...field ids...], ...]}`` ->
  ``{"predictions": [...], "latency_ms": ...}``.  Raw ids are accepted:
  the Predictor applies the checkpoint's feature-hash spec when present.
- ``GET /healthz`` — liveness + model/schema info + request counters.
- ``GET /metrics`` — Prometheus text exposition of the same counters.

Threaded stdlib server: requests are parsed and serialised concurrently;
the scoring submission goes through one lock (one card), and the fetch of
the result happens outside it, so concurrent requests overlap on the card.

    python -m tpurec_torch.server --ckpt save/mmoe_synthetic_seed7.pkl \\
        --port 8080 --table_dtype bfloat16 --bs 4096 --device cuda
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_server(predictor, host: str = "127.0.0.1", port: int = 8080,
                model_name: str = "") -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer wired to ``predictor``.

    Call ``.serve_forever()`` (blocking) or drive it from a thread; the
    bound port is ``server.server_address[1]`` (useful with port=0).
    """
    lock = threading.Lock()
    stats = {"n_requests": 0, "n_rows": 0, "latency_ms_sum": 0.0}
    n_fields = len(predictor.field_dims)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every reply carries Content-Length, so
        # persistent connections are safe
        protocol_version = "HTTP/1.1"
        # one packet per reply: buffered writes + TCP_NODELAY avoid the
        # Nagle / delayed-ACK stall between header and body segments
        wbufsize = 64 * 1024
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/metrics":
                q_bytes, _ = predictor.table_bytes()
                with lock:
                    snap = dict(stats)
                body = (
                    "# TYPE tpurec_requests_total counter\n"
                    f"tpurec_requests_total {snap['n_requests']}\n"
                    "# TYPE tpurec_rows_total counter\n"
                    f"tpurec_rows_total {snap['n_rows']}\n"
                    "# TYPE tpurec_latency_ms_sum counter\n"
                    f"tpurec_latency_ms_sum {snap['latency_ms_sum']:.3f}\n"
                    "# TYPE tpurec_table_bytes gauge\n"
                    f"tpurec_table_bytes {q_bytes}\n"
                ).encode()
                return self._send(200, body, "text/plain; version=0.0.4")
            if self.path != "/healthz":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            with lock:
                snap = dict(stats)
            self._reply(200, {
                "status": "ok",
                "model": model_name or predictor.model_name,
                "n_fields": n_fields,
                "table_dtype": predictor.table_dtype,
                "hash_fields": sorted(predictor.hash_buckets),
                **snap,
            })

        def _drain_body(self) -> None:
            # HTTP/1.1 keep-alive: an early reply that leaves the request
            # body unread desyncs the persistent connection (the body
            # bytes would be parsed as the next request).  Consume them.
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = 0
            while length > 0:
                chunk = self.rfile.read(min(length, 64 * 1024))
                if not chunk:
                    break
                length -= len(chunk)

        def do_POST(self):
            if self.path != "/predict":
                self._drain_body()
                return self._reply(404, {"error": f"unknown path {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                X = np.asarray(payload["instances"], dtype=np.int64)
                if X.ndim != 2 or X.shape[1] != n_fields:
                    raise ValueError(
                        f"instances must be [N, {n_fields}] ints, "
                        f"got shape {X.shape}")
            except Exception as e:  # malformed request -> 400, not a crash
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            try:
                t0 = time.perf_counter()
                # lock only the submission; the fetch waits outside it
                with lock:
                    fetch = predictor.predict_async(X)
                probs = fetch()
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    stats["n_requests"] += 1
                    stats["n_rows"] += len(probs)
                    stats["latency_ms_sum"] += ms
                self._reply(200, {
                    "predictions": [float(p) for p in probs],
                    "latency_ms": round(ms, 3),
                })
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    from tpurec_torch.serve import _TABLE_DTYPES, predictor_from_checkpoint

    p = argparse.ArgumentParser(description="tpurec_torch HTTP serving host")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--bs", type=int, default=4096)
    p.add_argument("--table_dtype", default="float32",
                   choices=list(_TABLE_DTYPES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    pred = predictor_from_checkpoint(
        args.ckpt, batch_sizes=(args.bs,), table_dtype=args.table_dtype,
        device=args.device)
    pred.warm()
    srv = make_server(pred, args.host, args.port)
    print(f"serving {args.ckpt} on http://{args.host}:{srv.server_address[1]} "
          f"(bs={args.bs}, table={args.table_dtype}, device={args.device})",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
