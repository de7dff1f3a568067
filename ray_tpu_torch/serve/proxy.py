"""HTTP ingress proxy on the standard library, routing to deployment
handles (the port's counterpart of ``ray_tpu/serve/proxy.py``).

Equivalent of the reference's per-node HTTPProxy
(reference: python/ray/serve/_private/proxy.py:896,975 uvicorn ASGI proxy,
proxy_request :364 → Router.assign_replica). The JAX package serves it
with aiohttp, which the card's machine does not have; the port serves the
same surface with ``http.server.ThreadingHTTPServer`` in a daemon thread,
one thread a connection, HTTP/1.1 with keep-alive. What a client sees is
the aiohttp proxy's: route matching, ``/healthz`` from local state,
``/debug/llm``, the JSON bodies (``application/json; charset=utf-8``),
streamed responses in chunked transfer encoding (server-sent events
``data: ...\n\n`` under ``Accept: text/event-stream``, raw chunks
otherwise), the statuses of ``_status_for`` with their ``Retry-After``,
the trace-id header, the access log, and a client that hangs up
mid-stream cancels its request on the replica. Only ``Server`` (and the
keep-alive bookkeeping) differ.
"""
from __future__ import annotations

import contextlib
import http
import itertools
import json
import logging
import random
import threading
import time
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qsl, unquote, urlsplit

from ray_tpu_torch._private import event_stats
from ray_tpu_torch.exceptions import (
    DeadlineExceededError,
    EngineOverloadedError,
    RequestCancelledError,
    TaskError,
)
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponseGenerator
from ray_tpu_torch.util import tracing

# Structured access logs (one JSON object per line).
_access_logger = logging.getLogger("ray_tpu_torch.serve.access")

# Request header that opts a call into
# tracing; the assigned trace id is echoed back on this response header.
TRACE_HEADER = "x-ray-tpu-trace"
TRACE_ID_HEADER = "x-ray-tpu-trace-id"

# Request header naming the LLM scheduling class ("interactive" |
# "default" | "batch"); injected into dict payloads as ``priority``.
PRIORITY_HEADER = "x-ray-tpu-priority"

# Class-aware backoff hints: interactive retries fast (capacity opens as
# soon as a stream completes), batch backs off hard (it is the first class
# shed and the last resumed under sustained overload).
_RETRY_AFTER = {"interactive": "1", "default": "2", "batch": "5"}


def head_sampler(seed: str, rate: float):
    """Head-sampling decision for one proxy: trace ``rate`` of requests
    that did NOT opt in via the trace header, so production traffic feeds
    the fleet TraceStore without client cooperation. A closure over a
    seeded RNG (the repo-wide ``random.Random(zlib.crc32(...))`` pattern —
    never the process-global ``random.random()``) so the sampled share is
    deterministic per seed and replayable in tests."""
    rng = random.Random(zlib.crc32(seed.encode()))

    def sample() -> bool:
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        return rng.random() < rate

    return sample


def log_access(proxy: str, path: str, state: dict, *, status: str,
               error: str | None = None) -> None:
    """Emit one structured access-log line. ``state`` accumulates during
    the request: t0 (perf-counter start), request_id, trace_id, ttft_ms,
    tokens, resumed. Idempotent — streams can hit both the handler's error
    path and the pump's completion path."""
    if state.get("_logged"):
        return
    state["_logged"] = True
    dur = time.perf_counter() - state["t0"] if "t0" in state else 0.0
    event_stats.record(f"serve.proxy.{proxy}.request", dur)
    _access_logger.info(json.dumps({
        "proxy": proxy,
        "path": path,
        "request_id": state.get("request_id"),
        "trace_id": state.get("trace_id"),
        "status": status,
        "ttft_ms": state.get("ttft_ms"),
        "tokens": state.get("tokens", 0),
        "resumed": state.get("resumed", 0),
        "duration_ms": round(dur * 1000.0, 3),
        "error": error,
    }, default=str))


def _unwrap(e: BaseException) -> BaseException:
    if isinstance(e, TaskError) and e.cause is not None:
        return e.cause
    return e


def _status_for(e: BaseException,
                priority: str | None = None) -> tuple[int, dict]:
    """Map framework errors to HTTP degradation statuses: overload is
    retryable (503 + Retry-After, with a class-aware backoff hint and a
    per-priority shed counter — under class-aware shedding batch is
    rejected first, so operators can see WHICH class is degraded), a
    blown deadline is a gateway timeout (504), a cancelled request is
    nginx's client-closed-request (499), and a request-validation
    ValueError — including GrammarError for an invalid or unsatisfiable
    response_format — is the client's fault (400, never a 500/failover).
    """
    from ray_tpu_torch.util import metrics

    e = _unwrap(e)
    if isinstance(e, EngineOverloadedError):
        pc = priority or "default"
        metrics.counter(
            "serve_requests_shed",
            "Requests rejected with an overload status at a proxy, "
            "by priority class",
            tag_keys=("proxy", "priority"),
        ).inc(tags={"proxy": "http", "priority": pc})
        return 503, {"Retry-After": _RETRY_AFTER.get(pc, "2")}
    if isinstance(e, DeadlineExceededError):
        return 504, {}
    if isinstance(e, RequestCancelledError):
        return 499, {}
    if isinstance(e, ValueError):
        return 400, {}
    return 500, {}


class _PrefetchedStream:
    """A streaming response whose FIRST chunk was already fetched.
    Fetching one chunk before building the HTTP response
    means admission-control/deadline errors surface while the status line
    is still unsent — so overload really is a 503, not a 200 + mid-stream
    error chunk."""

    def __init__(self, chunks):
        self.chunks = chunks

    def __iter__(self):
        return iter(self.chunks)


def _encode_chunk(chunk: Any, sse: bool) -> bytes:
    if sse:
        if isinstance(chunk, bytes):
            body = chunk.decode(errors="replace")
        elif isinstance(chunk, str):
            body = chunk
        else:
            body = json.dumps(chunk)
        return b"data: " + body.encode() + b"\n\n"
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return json.dumps(chunk).encode() + b"\n"


def _reason(status: int) -> str:
    """The reason phrase aiohttp sends (empty for a code it does not
    know, such as 499)."""
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return ""


class _Handler(BaseHTTPRequestHandler):
    """One connection's requests; ``server.proxy`` is the HTTPProxy."""

    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # the proxy writes its own access log

    def do_GET(self):
        self.server.proxy._handle(self)

    do_POST = do_PUT = do_DELETE = do_PATCH = do_OPTIONS = do_GET

    # -- response writers --

    def start(self, status: int, headers: dict) -> None:
        self.send_response_only(status, _reason(status))
        self.send_header("Date", self.date_time_string())
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()

    def send_json(self, obj, status: int = 200, headers: dict | None = None,
                  dumps=json.dumps) -> None:
        body = dumps(obj).encode()
        self.start(status, {**(headers or {}),
                            "Content-Type": "application/json; charset=utf-8",
                            "Content-Length": str(len(body))})
        self.wfile.write(body)
        self.wfile.flush()

    def write_chunk(self, data: bytes) -> None:
        if data:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()


class HTTPProxy:
    def __init__(self, options: HTTPOptions):
        self.options = options
        self._head_sample = head_sampler(
            f"http:{options.host}:{options.port}", options.trace_sample_rate)
        self.port: int | None = None  # bound port (options.port=0 works)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # route_prefix -> (app_name, ingress deployment)
        self._routes: dict[str, tuple[str, str]] = {}
        self._routes_lock = threading.Lock()

    # -- route table --

    def set_route(self, route_prefix: str, app_name: str, ingress: str) -> None:
        with self._routes_lock:
            self._routes[route_prefix.rstrip("/") or "/"] = (app_name, ingress)

    def replace_routes(self, routes: dict[str, tuple[str, str]]) -> None:
        """Swap in a full route table (proxy-actor route sync)."""
        with self._routes_lock:
            self._routes = {
                (k.rstrip("/") or "/"): tuple(v) for k, v in routes.items()
            }

    def remove_routes_for_app(self, app_name: str) -> None:
        with self._routes_lock:
            self._routes = {
                k: v for k, v in self._routes.items() if v[0] != app_name
            }

    def _match(self, path: str) -> tuple[str, str] | None:
        with self._routes_lock:
            best = None
            for prefix, target in self._routes.items():
                if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, target)
            return best[1] if best else None

    # -- server --

    def start(self) -> None:
        server = ThreadingHTTPServer(
            (self.options.host, self.options.port), _Handler)
        server.daemon_threads = True
        server.proxy = self
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="serve-http-proxy")
        self._thread.start()

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()

    # -- requests --

    def _handle(self, h: _Handler) -> None:
        url = urlsplit(h.path)
        path = unquote(url.path)
        query: dict[str, str] = {}
        for k, v in parse_qsl(url.query, keep_blank_values=True):
            query.setdefault(k, v)  # a repeated key keeps its first value
        if path == "/healthz":
            # controller-INDEPENDENT readiness: answers from purely
            # local state, so load balancers keep this proxy in
            # rotation through a controller outage (routing keeps
            # working from cached tables; see handle._Router._refresh)
            with self._routes_lock:
                n_routes = len(self._routes)
            h.send_json({"status": "ok", "routes": n_routes})
            return
        if path == "/debug/llm":
            self._debug_llm(h, query)
            return
        target = self._match(path)
        if target is None:
            h.send_json({"error": f"no app routes {path}"}, status=404)
            return
        app_name, ingress = target
        length = int(h.headers.get("Content-Length") or 0)
        if length > 0:
            raw = h.rfile.read(length)
            try:
                payload: Any = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                payload = raw.decode()
        else:
            payload = dict(query) or None
        # For generator ingresses the first chunk is fetched before the
        # status line goes out, so admission and deadline errors map to a
        # status code; remaining chunks stream as they arrive.
        traced = TRACE_HEADER in h.headers or self._head_sample()
        prio_header = h.headers.get(PRIORITY_HEADER)
        state: dict[str, Any] = {"t0": time.perf_counter()}

        def call_blocking():
            nonlocal payload
            root = (
                tracing.span("http.request", path=path, method=h.command)
                if traced else contextlib.nullcontext({})
            )
            with root as ctx:
                if ctx.get("trace_id"):
                    state["trace_id"] = ctx["trace_id"]
                handle = DeploymentHandle(ingress, app_name).options(
                    stream_chunk_timeout_s=self.options.request_timeout_s)
                if isinstance(payload, dict):
                    try:
                        streaming_ingress = (
                            "__call__" in handle.stream_methods())
                    except Exception:  # noqa: BLE001 — best-effort tag
                        streaming_ingress = False
                    if streaming_ingress:
                        # tag the request so a client disconnect can
                        # cancel it on whichever replica is serving it
                        payload = dict(payload)
                        payload.setdefault("request_id", uuid.uuid4().hex)
                        # priority class rides the header (payload key
                        # wins); class-aware shedding and per-class
                        # overload accounting key on it
                        if prio_header:
                            payload.setdefault("priority", prio_header)
                        state["request_id"] = payload["request_id"]
                        state["handle"] = handle
                    if payload.get("priority"):
                        state["priority"] = str(payload["priority"])
                response = handle.remote(payload)
                if isinstance(response, DeploymentResponseGenerator):
                    it = iter(response)
                    try:
                        first = next(it)
                    except StopIteration:
                        return _PrefetchedStream(())
                    state["ttft_ms"] = round(
                        (time.perf_counter() - state["t0"]) * 1000.0, 3)
                    return _PrefetchedStream(itertools.chain([first], it))
                return response.result(
                    timeout=self.options.request_timeout_s)

        try:
            result = call_blocking()
        except Exception as e:  # noqa: BLE001 — surface to the client
            status, headers = _status_for(e, state.get("priority"))
            log_access("http", path, state, status=str(status), error=str(e))
            h.send_json({"error": str(e)}, status=status, headers=headers)
            return
        trace_headers = ({TRACE_ID_HEADER: state["trace_id"]}
                         if "trace_id" in state else {})
        if isinstance(result, _PrefetchedStream):
            self._stream(h, path, state, result, trace_headers)
            return
        log_access("http", path, state, status="200")
        if isinstance(result, (dict, list, str, int, float, bool, type(None))):
            h.send_json({"result": result}, headers=trace_headers)
        else:
            h.send_json({"result": repr(result)}, headers=trace_headers)

    def _stream(self, h: _Handler, path: str, state: dict,
                result: "_PrefetchedStream", headers: dict) -> None:
        """Write chunks out as the replica produces them — token
        streaming for LLM decode (reference: serve/_private/proxy.py
        streaming ASGI responses). Server-sent events when the client
        asks for text/event-stream; raw chunked transfer otherwise. A
        client that hangs up (the write fails) cancels its request on
        the replica, freeing its sequence and KV blocks instead of
        decoding into the void until max_new_tokens."""
        sse = "text/event-stream" in h.headers.get("Accept", "")
        h.start(200, {**headers,
                      "Content-Type": ("text/event-stream" if sse
                                       else "application/octet-stream"),
                      "Transfer-Encoding": "chunked"})
        chunks = iter(result)
        try:  # only the writes raise into this: the client hung up
            while True:
                try:
                    chunk = next(chunks)
                except StopIteration:
                    log_access("http", path, state, status="200")
                    break
                except BaseException as e:  # noqa: BLE001 — to the client
                    log_access("http", path, state, status="error",
                               error=str(e))
                    h.write_chunk(_encode_chunk({"error": str(e)}, sse))
                    break
                state["tokens"] = state.get("tokens", 0) + 1
                h.write_chunk(_encode_chunk(chunk, sse))
            h.wfile.write(b"0\r\n\r\n")
            h.wfile.flush()
        except (ConnectionError, OSError):
            h.close_connection = True
            log_access("http", path, state, status="disconnect")
            rid = state.get("request_id")
            handle = state.get("handle")
            if rid is not None and handle is not None:
                threading.Thread(
                    target=lambda: handle.broadcast("cancel", rid),
                    daemon=True, name="serve-cancel",
                ).start()

    def _debug_llm(self, h: _Handler, query: dict) -> None:
        """GET /debug/llm?app=<name>: broadcast ``debug_dump()`` to every
        replica of the app's ingress deployment — flight-recorder snapshot
        + scheduler/cache stats per replica, as JSON (None where a replica
        failed or lacks the method)."""
        app_name = query.get("app", "default")
        with self._routes_lock:
            apps = {a: ing for (a, ing) in self._routes.values()}
        ingress = apps.get(app_name)
        if ingress is None:
            h.send_json({"error": f"unknown app {app_name!r}",
                         "apps": sorted(apps)}, status=404)
            return
        try:
            dumps = DeploymentHandle(ingress, app_name).broadcast("debug_dump")
        except Exception as e:  # noqa: BLE001 — surface to the client
            h.send_json({"error": str(e)}, status=500)
            return
        h.send_json({"app": app_name, "replicas": dumps},
                    dumps=lambda o: json.dumps(o, default=str))
