"""HTTP frontend for the serving plane — stdlib only; the port's copy of
`deeplearning4j_tpu/serving/http.py`, routes and status codes unchanged.

Every rejection the `InferenceServer` produces maps to an explicit
status code; an overloaded or degraded server answers fast with a
reason, never hangs the socket:

  POST /v1/infer    {"features": [...], "deadline_ms": 250,
                     "features_mask": [1, 1, 0]}  # optional (T,) keep-mask
                    -> 200 {"outputs": ..., "latency_ms", "generation"}
                    -> 400 bad request  (malformed JSON / wrong shape)
                    -> 429 queue_full   (backpressure: retry later)
                    -> 503 breaker_open | deadline | admit_fault
                    -> 504 deadline expired after admission
                    -> 500 dispatch failed (wedged / non-finite)
  POST /v1/generate {"prompt": [1, 7, 3], "max_new_tokens": 32,
                     "temperature": 0.8, "top_k": 40, "seed": 0,
                     "stop_tokens": [2], "stream": false,
                     "spec_k": 2}   # optional per-request speculative
                                    # draft length, capped at the
                                    # engine's spec_k (0 = plain decode
                                    # for this stream)
                    -> 200 {"tokens", "prompt_len", "ttft_ms",
                            "generation"}
                    -> 200 (stream=true) newline-delimited JSON chunks
                       {"token", "index"} ... then {"done": true}
                    -> 400 bad request (no engine / over-capacity
                           stream / malformed prompt)
                    -> 429 queue_full | kv_exhausted (retry later)
                    -> 503 breaker_open
                    -> 500 prefill/decode step failed
  POST /v1/reload   {"path": "/ckpts/ckpt_00000042.zip"}
                    -> 200 installed {"generation"}
                    -> 409 rolled_back (verification failed; old params
                           keep serving)
  GET  /healthz     -> 200 serving | 503 breaker open (load balancers
                       pull the replica while it probes recovery);
                       carries the SLO summary (alerting objectives +
                       fast-window burn) when an `observe.slo` engine
                       is installed
  GET  /v1/status   -> 200 stats JSON (queue depth, p50/p99, breaker,
                       swap generation, shed counts, per-request
                       latency_breakdown, slo state; when token
                       generation is enabled, a "generation" block with
                       stream outcomes, tokens/s, the queue/prefill/
                       handoff/decode/sampling breakdown, and flight-
                       recorder counters)

Multi-input graphs POST ``{"inputs": [[...], [...]]}`` — one nested
array per network input.  Features arrive as ONE example (no batch
dim); the server does the batching.  Where the JAX package reads every
feature as float32, the port keeps an all-integer array integer: token
ids reach the embedding as ids, not as floats a bf16 cast would round
(ROADMAP C4).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import (
    ServingError, ServingRejected, ServingTimeout,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


def _slo_summary():
    """The active SLO engine's compact summary (None when no engine is
    installed — plain replicas pay nothing).  /healthz is a routing
    decision point, so the engine is SAMPLED on read — the burn rates a
    load balancer sees must be current even if nothing is scraping
    /metrics on this replica."""
    from deeplearning4j_tpu_torch.observe.slo import sample_active_summary

    return sample_active_summary()


def _slo_state():
    from deeplearning4j_tpu_torch.observe.slo import sample_active_state

    return sample_active_state()


def _features(a) -> np.ndarray:
    """A request's features: integer arrays stay integer (token ids),
    everything else is float32."""
    arr = np.asarray(a)
    if np.issubdtype(arr.dtype, np.integer):
        return arr
    return arr.astype(np.float32)


class ServingHTTPServer:
    """Thin HTTP shell around an `InferenceServer`."""

    def __init__(self, server, port: int = 0, host: str = "127.0.0.1"):
        self.server = server
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # per-connection socket timeout: a client that sends headers
            # and then dribbles (or never sends) its body must not pin
            # a handler thread forever — bounded admission starts at
            # the socket
            timeout = 30

            def log_message(self, *a):          # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/healthz":
                    # the pull-based LB payload (docs/serving.md schema):
                    # shed_pressure / breaker_state / batch_latency_ewma_s
                    # / weights_generation let a router stop sending to
                    # this replica BEFORE it starts shedding
                    health = outer.server.health()
                    health["breaker"] = health["breaker_state"]
                    slo = _slo_summary()
                    if slo is not None:
                        health["slo"] = slo
                    self._json(
                        health,
                        503 if health["status"] == "breaker_open" else 200,
                    )
                elif u.path == "/v1/status":
                    stats = outer.server.stats()
                    engine = getattr(outer.server, "generation_engine",
                                     None)
                    if engine is not None:
                        try:
                            stats["generation"] = engine.stats()
                        except Exception as e:
                            log.debug("status generation join "
                                      "failed: %s", e)
                    slo = _slo_state()
                    if slo is not None:
                        stats["slo"] = slo
                    self._json(stats)
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                u = urlparse(self.path)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._json({"error": "bad json"}, 400)
                    return
                if u.path == "/v1/infer":
                    self._infer(payload)
                elif u.path == "/v1/generate":
                    self._generate(payload)
                elif u.path == "/v1/reload":
                    self._reload(payload)
                else:
                    self._json({"error": "not found"}, 404)

            def _generate(self, payload):
                engine = getattr(outer.server, "generation_engine", None)
                if engine is None:
                    self._json(
                        {"error": "no generation engine attached to "
                                  "this replica"}, 400)
                    return
                try:
                    prompt = np.asarray(
                        payload.get("prompt"), np.int32).reshape(-1)
                except (TypeError, ValueError) as exc:
                    self._json({"error": f"bad prompt: {exc}"}, 400)
                    return
                kwargs = dict(
                    max_new_tokens=payload.get("max_new_tokens"),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=int(payload.get("top_k", 0)),
                    seed=int(payload.get("seed", 0)),
                    stop_tokens=tuple(payload.get("stop_tokens", ())),
                )
                if payload.get("spec_k") is not None:
                    try:
                        kwargs["spec_k"] = int(payload["spec_k"])
                    except (TypeError, ValueError) as exc:
                        self._json({"error": f"bad spec_k: {exc}"}, 400)
                        return
                timeout = float(payload.get("timeout_s", 120.0))
                if payload.get("stream"):
                    self._generate_stream(engine, prompt, kwargs, timeout)
                    return
                try:
                    req = engine.submit(prompt, **kwargs)
                    out = req.result(timeout)
                except ServingRejected as exc:
                    self._json({"error": str(exc), "reason": exc.reason},
                               exc.status)
                    return
                except ServingTimeout as exc:
                    self._json({"error": str(exc),
                                "reason": "deadline_expired"}, exc.status)
                    return
                except ServingError as exc:
                    self._json({"error": str(exc),
                                "reason": "dispatch_failed"}, exc.status)
                    return
                except ValueError as exc:   # over-capacity stream etc.
                    self._json({"error": str(exc)}, 400)
                    return
                self._json({
                    "tokens": np.asarray(out).tolist(),
                    "prompt_len": int(prompt.shape[0]),
                    "ttft_ms": (round(req.ttft_s * 1000.0, 3)
                                if req.ttft_s is not None else None),
                    "generation": outer.server.generation,
                })

            def _generate_stream(self, engine, prompt, kwargs, timeout):
                """Chunked newline-delimited JSON: one {"token", "index"}
                line per generated token as the decode loop emits it,
                then a {"done": true} terminator carrying the totals."""
                import queue as _q

                chunks: _q.Queue = _q.Queue()

                def on_token(tok, idx):
                    chunks.put((tok, idx))

                try:
                    req = engine.submit(prompt, on_token=on_token,
                                        **kwargs)
                except ServingRejected as exc:
                    self._json({"error": str(exc), "reason": exc.reason},
                               exc.status)
                    return
                except ValueError as exc:
                    self._json({"error": str(exc)}, 400)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(obj):
                    body = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(body):x}\r\n".encode())
                    self.wfile.write(body + b"\r\n")
                    self.wfile.flush()

                import time as _t

                t_end = _t.monotonic() + timeout
                try:
                    while True:
                        try:
                            tok, idx = chunks.get(timeout=0.1)
                            send({"token": int(tok), "index": int(idx)})
                        except _q.Empty:
                            if req.done and chunks.empty():
                                break
                            if _t.monotonic() > t_end:
                                req.cancel()
                                break
                    err = req.error
                    send({"done": True,
                          "n_tokens": len(req.tokens_so_far()),
                          "error": str(err) if err is not None else None,
                          "ttft_ms": (round(req.ttft_s * 1000.0, 3)
                                      if req.ttft_s is not None
                                      else None)})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # client hung up mid-stream: stop decoding for them
                    req.cancel()

            def _infer(self, payload):
                try:
                    if "inputs" in payload:
                        feats = tuple(
                            _features(a) for a in payload["inputs"])
                    else:
                        feats = _features(payload.get("features"))
                    fmask = payload.get("features_mask")   # checked at admit
                    deadline_ms = payload.get("deadline_ms")
                    deadline_s = (
                        float(deadline_ms) / 1000.0
                        if deadline_ms is not None else None
                    )
                except (TypeError, ValueError) as exc:
                    self._json({"error": f"bad features: {exc}"}, 400)
                    return
                import time

                t0 = time.monotonic()
                try:
                    req = outer.server.submit(feats, deadline_s=deadline_s,
                                              features_mask=fmask)
                    result = req.result()
                except ServingRejected as exc:
                    self._json(
                        {"error": str(exc), "reason": exc.reason},
                        exc.status,
                    )
                    return
                except ServingTimeout as exc:
                    self._json({"error": str(exc),
                                "reason": "deadline_expired"}, exc.status)
                    return
                except ServingError as exc:
                    self._json({"error": str(exc),
                                "reason": "dispatch_failed"}, exc.status)
                    return
                except ValueError as exc:      # wrong arity/shape
                    self._json({"error": str(exc)}, 400)
                    return
                outs = (
                    [np.asarray(o).tolist() for o in result]
                    if isinstance(result, tuple)
                    else np.asarray(result).tolist()
                )
                self._json({
                    "outputs": outs,
                    "latency_ms": round(
                        (time.monotonic() - t0) * 1000.0, 3,
                    ),
                    "generation": outer.server.generation,
                })

            def _reload(self, payload):
                path = payload.get("path")
                if not path:
                    self._json({"error": "missing 'path'"}, 400)
                    return
                if outer.server.push_checkpoint(path):
                    self._json({"installed": True,
                                "generation": outer.server.generation})
                else:
                    self._json(
                        {"installed": False,
                         "error": "verification failed; previous "
                                  "weights keep serving"},
                        409,
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}/"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServingHTTPServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="dl4jtpu-serving-http",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
