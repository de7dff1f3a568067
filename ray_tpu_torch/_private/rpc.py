"""Control-plane RPC: msgpack-framed messages over TCP (the port's copy of
``ray_tpu/_private/rpc.py``, framed by ``wire.py``, byte for byte the
msgpack of the JAX core).

Equivalent in role to the reference's gRPC wrapper layer
(reference: src/ray/rpc/grpc_server.h, client_call.h — async server/client
call templates over an asio io_context). The control plane here is
deliberately small: length-prefixed msgpack arrays over TCP, a
selector-based event-loop server (one loop thread multiplexes every
connection; handlers run on a small on-demand pool with per-connection
FIFO ordering — the asio analog, NOT thread-per-connection, which kept
one idle OS thread per open socket and capped node fan-in), plus
server→client push notifications (used for task completion, pubsub
delivery, and actor state changes — the analog of the reference's
long-poll pubsub, src/ray/pubsub/publisher.h).

Wire format: [u32 len][msgpack array]
  request:  [0, msgid, method: str, payload]
  response: [1, msgid, ok: bool, payload_or_error]
  notify:   [2, 0, topic: str, payload]
"""
from __future__ import annotations

import collections
import selectors
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

from ray_tpu_torch._private import event_stats, wire

REQUEST, RESPONSE, NOTIFY = 0, 1, 2


def _pack(obj: Any) -> bytes:
    body = wire.packb(obj)
    return struct.pack("<I", len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n > 0:
        try:
            c = sock.recv(n)
        except OSError:
            return None
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _read_msg(sock: socket.socket) -> list | None:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack("<I", header)
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return wire.unpackb(body)


class Connection:
    """Server-side handle to one client connection; safe concurrent sends.

    The socket is nonblocking and owned by the server's event loop:
    send() from ANY thread appends to the connection's outbox and wakes
    the loop, which flushes when the socket is writable (asio-style
    buffered writes — a slow reader can no longer block a pool thread
    inside sendall)."""

    def __init__(self, sock: socket.socket, peer: str, server: "RpcServer"):
        self.sock = sock
        self.peer = peer
        self._server = server
        self.closed = False
        # Services can attach identity here (e.g. worker id after register).
        self.meta: dict[str, Any] = {}
        self.on_close: list[Callable[[Connection], None]] = []
        # event-loop state (guarded by the server's conn lock)
        self._rbuf = bytearray()
        self._outbox: collections.deque[bytes] = collections.deque()
        self._out_off = 0  # partial-write offset into outbox[0]
        self._out_bytes = 0  # slow-consumer accounting
        self._handshaken = False
        # per-connection FIFO handler dispatch
        self._tasks: collections.deque[list] = collections.deque()
        self._draining = False
        self._paused = False  # READ interest dropped (task backlog)

    def send(self, msg: list) -> bool:
        """False when the connection is known-dead (reader saw EOF/error).
        Like the old blocking sendall, a send that races death may still
        report True — definitive failure surfaces via on_close."""
        if self.closed:
            return False
        return self._server._enqueue_send(self, _pack(msg))

    def notify(self, topic: str, payload: Any) -> bool:
        return self.send([NOTIFY, 0, topic, payload])

    def close(self) -> None:
        self.closed = True
        self._server._request_close(self)


class RpcServer:
    """Selector-based RPC server dispatching to handler methods.

    One event-loop thread multiplexes accept/read/write for every
    connection (the reference's asio io_context shape,
    src/ray/rpc/grpc_server.h); complete frames dispatch onto a small
    on-demand thread pool with PER-CONNECTION FIFO ordering, so handler
    semantics match the old thread-per-connection server (one in-flight
    request per connection, cross-connection parallelism) without an OS
    thread pinned per idle socket — the former node-fan-in ceiling.

    Handlers are methods named ``rpc_<method>`` on the service object,
    called as ``handler(conn, msgid, payload)``; the return value is the
    response payload. A handler may instead return the DEFERRED sentinel
    and later complete the call via
    ``conn.send([RESPONSE, msgid, True, payload])`` — used for blocking
    calls (e.g. waiting on an actor to start) without tying up a pool
    thread.
    """

    DEFERRED = object()
    _POOL_WORKERS = 16
    # slow-consumer policy: a peer that stops reading while we keep
    # sending gets dropped once its outbox crosses this (gRPC's
    # resource-exhausted analog); a peer that pipelines requests faster
    # than handlers drain has its READ interest paused (TCP backpressure)
    _MAX_OUTBOX_BYTES = 64 * 1024 * 1024
    _MAX_PENDING_TASKS = 10_000

    def __init__(self, service: Any, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        # strict wire-schema validation (schema.py): services declare their
        # schema table via a `schema_service` class attribute
        self._schema_service = getattr(service, "schema_service", None)
        from ray_tpu_torch._private import schema as _schema

        self._strict = _schema.strict_mode()
        # handler-latency accounting (event_stats.py; the reference's
        # instrumented_io_context records every asio handler the same way)
        self._stats_name = (self._schema_service
                            or type(service).__name__.lower())
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if port == 0:
            self._srv.bind((host, port))
        else:
            # fixed ports are used for restart-in-place (GCS FT); lingering
            # sockets from the previous incarnation can hold the port for a
            # moment — retry EADDRINUSE briefly; other errors fail fast
            import errno

            deadline = time.monotonic() + 10
            while True:
                try:
                    self._srv.bind((host, port))
                    break
                except OSError as e:
                    if e.errno != errno.EADDRINUSE or time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        self._srv.listen(512)
        self._srv.setblocking(False)
        self.address = f"{host}:{self._srv.getsockname()[1]}"
        self._stopped = threading.Event()
        self.connections: set[Connection] = set()
        self._conn_lock = threading.Lock()
        # pool threads spawn on demand up to the cap; an idle server holds
        # only the loop thread. Services whose handlers legitimately BLOCK
        # inline (e.g. the client server's rpc_client_wait) declare a
        # larger cap via a `rpc_pool_workers` class attribute.
        self._pool = ThreadPoolExecutor(
            max_workers=getattr(service, "rpc_pool_workers",
                                self._POOL_WORKERS),
            thread_name_prefix=f"rpc-pool-{self.address}")
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._pending_writes: set[Connection] = set()
        self._pending_closes: set[Connection] = set()
        self._pending_resumes: set[Connection] = set()
        self._sel.register(self._srv, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name=f"rpc-loop-{self.address}"
        )
        self._loop_thread.start()

    # ---------------- event loop ----------------

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _enqueue_send(self, conn: Connection, data: bytes) -> bool:
        with self._conn_lock:
            if conn.closed or conn not in self.connections:
                return False
            conn._outbox.append(data)
            conn._out_bytes += len(data)
            if conn._out_bytes > self._MAX_OUTBOX_BYTES:
                # peer stopped reading: cut it loose rather than buffer
                # toward OOM
                self._pending_closes.add(conn)
            self._pending_writes.add(conn)
        self._wake()
        return True

    def _request_close(self, conn: Connection) -> None:
        with self._conn_lock:
            self._pending_closes.add(conn)
        self._wake()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                events = self._sel.select(timeout=1.0)
            except OSError:
                break
            for key, mask in events:
                tag = key.data
                if tag == "accept":
                    self._do_accept()
                elif tag == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
                else:  # a Connection
                    conn: Connection = tag
                    if mask & selectors.EVENT_READ:
                        self._do_read(conn)
                    if mask & selectors.EVENT_WRITE:
                        self._do_write(conn)
            # apply cross-thread requests (sends/closes/resumes) after IO
            with self._conn_lock:
                writes = [c for c in self._pending_writes
                          if c in self.connections]
                self._pending_writes.clear()
                closes = list(self._pending_closes)
                self._pending_closes.clear()
                resumes = [c for c in self._pending_resumes
                           if c in self.connections]
                self._pending_resumes.clear()
            for conn in resumes:
                want = selectors.EVENT_READ | (
                    selectors.EVENT_WRITE if conn._outbox else 0)
                try:
                    self._sel.register(conn.sock, want, conn)
                except (KeyError, ValueError, OSError):
                    pass
            for conn in writes:
                self._do_write(conn)
            for conn in closes:
                self._drop_conn(conn)
        # loop exit: tear everything down
        with self._conn_lock:
            conns = list(self.connections)
        for conn in conns:
            self._drop_conn(conn)
        try:
            self._sel.close()
        except OSError:
            pass

    def _do_accept(self) -> None:
        while True:
            try:
                sock, addr = self._srv.accept()
            except BlockingIOError:
                return
            except OSError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, f"{addr[0]}:{addr[1]}", self)
            with self._conn_lock:
                self.connections.add(conn)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError, OSError):
                self._drop_conn(conn)

    def _do_read(self, conn: Connection) -> None:
        try:
            while True:
                chunk = conn.sock.recv(1 << 16)
                if not chunk:
                    self._drop_conn(conn)
                    return
                conn._rbuf += chunk
                if len(chunk) < (1 << 16):
                    break
        except BlockingIOError:
            pass
        except OSError:
            self._drop_conn(conn)
            return
        # extract complete frames
        buf = conn._rbuf
        frames = []
        off = 0
        while len(buf) - off >= 4:
            (length,) = struct.unpack_from("<I", buf, off)
            if len(buf) - off - 4 < length:
                break
            frames.append(bytes(buf[off + 4:off + 4 + length]))
            off += 4 + length
        if off:
            del buf[:off]
        if not frames:
            return
        with self._conn_lock:
            for raw in frames:
                conn._tasks.append(raw)
            start = not conn._draining and bool(conn._tasks)
            if start:
                conn._draining = True
            pause = (len(conn._tasks) > self._MAX_PENDING_TASKS
                     and not conn._paused)
            if pause:
                conn._paused = True
        if pause:
            # stop reading this socket: the kernel buffer fills and TCP
            # pushes back on the sender (the drainer resumes us)
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
        if start:
            try:
                self._pool.submit(self._drain_conn, conn)
            except RuntimeError:  # pool shut down mid-teardown
                with self._conn_lock:
                    conn._draining = False

    def _do_write(self, conn: Connection) -> None:
        try:
            while conn._outbox:
                data = conn._outbox[0]
                n = conn.sock.send(
                    memoryview(data)[conn._out_off:])
                conn._out_off += n
                conn._out_bytes -= n
                if conn._out_off < len(data):
                    break  # kernel buffer full
                conn._outbox.popleft()
                conn._out_off = 0
        except BlockingIOError:
            pass
        except OSError:
            self._drop_conn(conn)
            return
        # toggle WRITE interest to match backlog
        want = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if conn._outbox else 0)
        try:
            self._sel.modify(conn.sock, want, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _drop_conn(self, conn: Connection) -> None:
        with self._conn_lock:
            if conn not in self.connections:
                return
            self.connections.discard(conn)
            self._pending_writes.discard(conn)
            self._pending_closes.discard(conn)
            self._pending_resumes.discard(conn)
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        if conn.on_close:
            # death handlers can do real blocking work (the raylet's
            # actor-death path makes GCS calls) — never run them on the
            # event loop, which must keep serving every other connection
            try:
                self._pool.submit(self._run_on_close, conn)
            except RuntimeError:  # pool already shut down (server stop)
                self._run_on_close(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    @staticmethod
    def _run_on_close(conn: Connection) -> None:
        for cb in conn.on_close:
            try:
                cb(conn)
            except Exception:
                pass

    # ---------------- handler dispatch (pool threads) ----------------

    def _drain_conn(self, conn: Connection) -> None:
        """Process this connection's queued frames in order; exactly one
        drainer per connection at a time (FIFO semantics)."""
        while True:
            with self._conn_lock:
                if not conn._tasks or conn.closed:
                    conn._draining = False
                    return
                raw = conn._tasks.popleft()
                resume = (conn._paused
                          and len(conn._tasks) < self._MAX_PENDING_TASKS // 2)
                if resume:
                    conn._paused = False
                    self._pending_resumes.add(conn)
            if resume:
                self._wake()
            try:
                msg = wire.unpackb(raw)
                if not (isinstance(msg, list) and len(msg) == 4):
                    raise ValueError(f"malformed frame: {msg!r}")
                self._handle_msg(conn, msg)
            except Exception:
                # a malformed or handler-crashing frame must never wedge
                # the drainer with _draining stuck True — drop the peer,
                # like the old per-connection loop's finally did
                with self._conn_lock:
                    conn._draining = False
                self._request_close(conn)
                return

    def _handle_msg(self, conn: Connection, msg: list) -> None:
        mtype, msgid, method, payload = msg
        if mtype != REQUEST:
            return
        if method == "_handshake":
            # version negotiation, answered by the RPC layer itself
            # (schema.py; the analog of proto compatibility checks)
            from ray_tpu_torch._private import schema

            try:
                conn.send([RESPONSE, msgid, True,
                           schema.check_handshake(payload)])
                conn._handshaken = True
            except schema.SchemaError as e:
                conn.send([RESPONSE, msgid, False, str(e)])
            return
        if self._strict and not conn._handshaken:
            # the documented contract (docs/CROSS_LANGUAGE.md): the
            # FIRST call on a connection must be _handshake; in
            # strict mode enforce it server-side so incompatible
            # clients can't bypass version detection
            conn.send([RESPONSE, msgid, False,
                       "protocol error: first request on a "
                       "connection must be _handshake (strict mode)"])
            return
        handler = getattr(self.service, "rpc_" + method, None)
        if handler is None:
            conn.send([RESPONSE, msgid, False, f"no such method: {method}"])
            return
        try:
            if self._schema_service is not None and self._strict:
                from ray_tpu_torch._private import schema

                schema.validate_request(
                    self._schema_service, method, payload)
            t0 = time.perf_counter()
            c0 = time.thread_time()
            result = handler(conn, msgid, payload)
            event_stats.record(
                f"rpc.{self._stats_name}.{method}",
                time.perf_counter() - t0,
            )
            # CPU seconds of the handler itself: the honest "handler work"
            # measure when hundreds of in-process peers share one GIL and
            # wall time mostly measures the scheduler
            event_stats.record(
                f"rpc.{self._stats_name}.{method}.cpu",
                time.thread_time() - c0,
            )
            if result is not RpcServer.DEFERRED:
                conn.send([RESPONSE, msgid, True, result])
        except Exception:
            conn.send([RESPONSE, msgid, False, traceback.format_exc()])

    def stop(self) -> None:
        self._stopped.set()
        self._wake()
        try:
            self._srv.close()
        except OSError:
            pass
        self._loop_thread.join(timeout=5)
        self._pool.shutdown(wait=False)
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


class RpcClient:
    """Blocking request/response client with a background reader thread.

    Push notifications are delivered to ``notify_handler(topic, payload)``
    on the reader thread — handlers must be quick or hand off.
    """

    def __init__(
        self,
        address: str,
        notify_handler: Callable[[str, Any], None] | None = None,
        connect_timeout: float = 10.0,
        auto_reconnect: bool = False,
        reconnect_window: float = 10.0,
        handshake: bool = True,
    ):
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.address = address
        self._connect_timeout = connect_timeout
        self._auto_reconnect = auto_reconnect
        self._reconnect_window = reconnect_window
        # RLocks: the garbage collector may run an ObjectRef's __del__ on a
        # thread that holds either lock here (a Future's allocation inside
        # call_async, say), and the free it sends re-enters call_async
        self._send_lock = threading.RLock()
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.RLock()
        self._msgid = 0
        self._gen = 0  # connection generation; bumped by reconnect()
        self._notify_handler = notify_handler
        self._closed = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, args=(self._sock, 0), daemon=True,
            name=f"rpc-client-{address}",
        )
        self._reader.start()
        if handshake:
            # enforce protocol compatibility before the first real call
            # (schema.py PROTOCOL_VERSION; mismatch fails the connect)
            from ray_tpu_torch._private import schema

            try:
                self.call_async("_handshake", schema.handshake_payload()) \
                    .result(connect_timeout)
            except BaseException as e:
                # any failure mode (mismatch, timeout, peer drop) must tear
                # the client down — a leaked socket + reader thread per
                # retry otherwise accumulates in reconnect loops
                self.close()
                raise RpcError(f"handshake with {address} failed: {e}") from e

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        while not self._closed.is_set():
            msg = _read_msg(sock)
            if msg is None:
                break
            mtype = msg[0]
            if mtype == RESPONSE:
                _, msgid, ok, payload = msg
                with self._pending_lock:
                    fut = self._pending.pop(msgid, None)
                if fut is not None:
                    if ok:
                        fut.set_result(payload)
                    else:
                        fut.set_exception(RpcError(str(payload)))
            elif mtype == NOTIFY and self._notify_handler is not None:
                _, _, topic, payload = msg
                try:
                    self._notify_handler(topic, payload)
                except Exception:
                    traceback.print_exc()
        # Connection lost: fail all pending calls AND every future call —
        # a send after this point can land in the kernel buffer without
        # error and would otherwise pend forever. _dead is set under
        # _pending_lock so a racing call_async either sees the flag or has
        # its future registered before the sweep below. A reader whose
        # generation was superseded by reconnect() must NOT run the sweep:
        # the pending futures now belong to the new connection.
        with self._pending_lock:
            if gen != self._gen:
                return
            self._dead = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"connection to {self.address} lost"))
            self._pending.clear()

    _dead = False

    def call_async(self, method: str, payload: Any = None) -> Future:
        with self._pending_lock:
            if self._dead:
                fut: Future = Future()
                fut.set_exception(
                    ConnectionError(f"connection to {self.address} lost")
                )
                return fut
            self._msgid += 1
            msgid = self._msgid
            fut: Future = Future()
            self._pending[msgid] = fut
        data = _pack([REQUEST, msgid, method, payload])
        with self._send_lock:
            try:
                self._sock.sendall(data)
            except OSError as e:
                with self._pending_lock:
                    self._pending.pop(msgid, None)
                # The reader thread's connection-lost cleanup may have
                # already failed this future — don't double-complete.
                if not fut.done():
                    fut.set_exception(
                        ConnectionError(f"send to {self.address} failed: {e}")
                    )
        return fut

    def reconnect(self, connect_timeout: float | None = None) -> bool:
        """Re-establish a lost connection in place (e.g. GCS restart-in-place,
        reference: raylet reconnect on NotifyGCSRestart). The client object
        identity is preserved, so holders of this client (task-event buffer,
        cached peers) heal without re-plumbing. Returns True if a live
        connection exists afterwards."""
        with self._send_lock:
            with self._pending_lock:
                if self._closed.is_set():
                    return False
                if not self._dead:
                    return True
            host, port = self.address.rsplit(":", 1)
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=connect_timeout or self._connect_timeout
                )
            except OSError:
                return False
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._pending_lock:
                # close() may have landed after the check above: don't
                # install a socket/reader on a closed client
                if self._closed.is_set():
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return False
                self._gen += 1
                gen = self._gen
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError(f"connection to {self.address} lost")
                        )
                self._pending.clear()
                old = self._sock
                self._sock = sock
                self._dead = False
            try:
                old.close()
            except OSError:
                pass
            self._reader = threading.Thread(
                target=self._read_loop, args=(sock, gen), daemon=True,
                name=f"rpc-client-{self.address}",
            )
            self._reader.start()
        # re-run the protocol check: a restart-in-place may have come back
        # as an upgraded binary. A version mismatch raises (permanent);
        # transient handshake failures report the connection as not healed.
        from ray_tpu_torch._private import schema

        try:
            self.call_async("_handshake", schema.handshake_payload()) \
                .result(self._connect_timeout)
        except RpcError as e:
            self.close()
            raise RpcError(
                f"handshake with {self.address} failed after reconnect: {e}"
            ) from e
        except BaseException:
            return False
        return True

    def call(self, method: str, payload: Any = None, timeout: float | None = None) -> Any:
        try:
            return self.call_async(method, payload).result(timeout)
        except ConnectionError:
            if not self._auto_reconnect:
                raise
        # Auto-reconnect window: the server may be restarting in place.
        # Control-plane calls here are idempotent (registers, heartbeats,
        # gets, event appends), so a retry after reconnect is safe.
        deadline = time.monotonic() + self._reconnect_window
        while True:
            if self.reconnect():
                try:
                    return self.call_async(method, payload).result(timeout)
                except ConnectionError:
                    pass
            if self._closed.is_set() or time.monotonic() >= deadline:
                raise ConnectionError(
                    f"connection to {self.address} lost (reconnect window expired)"
                )
            time.sleep(0.1)

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class RpcError(Exception):
    """Remote handler raised; message carries the remote traceback."""
