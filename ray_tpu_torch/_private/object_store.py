"""Client for the C++ shared-memory object store daemon.

Equivalent of the reference's plasma client
(reference: src/ray/object_manager/plasma/client.cc — create/seal/get/release
over a unix socket, with the payload memory-mapped into the client). Objects
are written into per-object POSIX shm segments; `get` returns a zero-copy
memoryview over the mapping, which a device copy reads without an extra
host copy.

The port's copy of ``ray_tpu/_private/object_store.py``.
"""
from __future__ import annotations

import mmap
import os
import socket
import struct
import subprocess
import threading
import time
from dataclasses import dataclass

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError, GetTimeoutError

(OP_CREATE, OP_SEAL, OP_GET, OP_RELEASE, OP_DELETE, OP_CONTAINS, OP_LIST,
 OP_STATS, OP_SHUTDOWN, OP_SUBSCRIBE, OP_ABORT, OP_PIN, OP_UNPIN,
 OP_WAIT) = range(1, 15)
ST_OK, ST_NOT_FOUND, ST_EXISTS, ST_FULL, ST_TIMEOUT, ST_ERR, ST_EVICTED = range(7)
EV_SEALED, EV_EVICTED = 1, 2

# Sentinel returned by get() for objects that existed but were evicted —
# the trigger for owner-side lineage reconstruction.
EVICTED = object()

_CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cpp")


def build_store_binary() -> str:
    """Compile the store daemon with g++ (content-hash cached)."""
    from ray_tpu_torch._private.native_build import build_native

    src = os.path.join(_CPP_DIR, "store.cpp")
    return build_native(src, "ray_tpu_torch_store",
                        ["-O2", "-std=c++17", "-pthread"], ["-lrt"])


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("object store connection closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _pid_namespace() -> str | None:
    """The inode of this process's pid namespace, as the store daemon
    writes it into its segment names (store.cpp ``SegmentPrefix``)."""
    try:
        link = os.readlink("/proc/self/ns/pid")  # "pid:[4026531836]"
    except OSError:
        return None
    return link[link.find("[") + 1:link.rfind("]")] or None


def _gc_stale_segments() -> None:
    """Unlink rtt_store shm segments whose creating daemon is dead — a
    crash/teardown race can orphan a segment; this makes every store start
    self-healing instead of letting tmpfs fill over weeks of runs. Only a
    segment named for this process's pid namespace
    (``rtt_store_<pid>_<namespace>_...``) is judged: a pid of another
    namespace says nothing here, so its segments are left alone."""
    ns = _pid_namespace()
    if ns is None:
        return
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        parts = name.split("_")
        if not name.startswith("rtt_store_") or len(parts) < 5 or parts[3] != ns:
            continue
        try:
            pid = int(parts[2])
        except ValueError:
            continue
        try:
            os.kill(pid, 0)  # raises if the daemon is gone
        except ProcessLookupError:
            try:
                os.unlink("/dev/shm/" + name)
            except OSError:
                pass
        except PermissionError:
            pass  # someone else's live process


def start_store(
    socket_path: str, capacity_bytes: int, spill_dir: str | None = None,
    min_spilling_size: int | None = None,
) -> subprocess.Popen:
    """Launch the daemon and wait for its READY handshake. spill_dir
    defaults to <socket>.spill next to the socket; pass "" to disable
    spilling (pressure then fails creates instead). min_spilling_size is
    the per-pass spill batch floor (config.min_spilling_size)."""
    from ray_tpu_torch._private.config import global_config

    binary = build_store_binary()
    _gc_stale_segments()
    if spill_dir is None:
        spill_dir = socket_path + ".spill"
    if min_spilling_size is None:
        min_spilling_size = global_config().min_spilling_size
    argv = [binary, socket_path, str(capacity_bytes)]
    if spill_dir:
        argv.append(spill_dir)
        argv.append(str(min_spilling_size))
    proc = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
    )
    line = proc.stdout.readline()
    if b"READY" not in line:
        raise RuntimeError(f"object store failed to start: {line!r}")
    return proc


@dataclass
class _Mapping:
    buf: memoryview
    mm: mmap.mmap | None  # None for zero-size objects

    def close(self) -> None:
        # Views may still be exported (numpy arrays aliasing the mapping);
        # in that case leave the mapping to the GC rather than erroring.
        try:
            self.buf.release()
            if self.mm is not None:
                self.mm.close()
        except BufferError:
            pass


class ObjectStoreClient:
    """Thread-safe client; one socket, one lock (requests are short)."""

    # Max cached mmaps; beyond this the least-recently-used unreferenced
    # mapping is closed (closed-but-viewed mappings survive via the exported
    # memoryview's reference to the mmap object).
    MAX_MAPPINGS = 4096

    def __init__(self, socket_path: str):
        self._socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + 10
        while True:
            try:
                self._sock.connect(socket_path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        self._lock = threading.Lock()
        # object id -> open mapping; LRU-capped. Guarded by _map_lock.
        from collections import OrderedDict

        self._mappings: "OrderedDict[bytes, _Mapping]" = OrderedDict()
        # created-but-not-sealed mappings, promoted to _mappings on seal()
        self._pending_creates: dict[bytes, _Mapping] = {}
        self._map_lock = threading.Lock()
        # pooled secondary connections for blocking OP_WAITs
        self._wait_socks: list[socket.socket] = []
        self._wait_lock = threading.Lock()

    _MAX_WAIT_SOCKS = 8

    def _checkout_wait_sock(self) -> socket.socket:
        with self._wait_lock:
            if self._wait_socks:
                return self._wait_socks.pop()
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(self._socket_path)
        return s

    def _checkin_wait_sock(self, s: socket.socket) -> None:
        with self._wait_lock:
            if len(self._wait_socks) < self._MAX_WAIT_SOCKS:
                self._wait_socks.append(s)
                return
        try:
            s.close()
        except OSError:
            pass

    def _request(self, op: int, object_id: bytes, payload: bytes = b"") -> tuple[int, bytes]:
        msg = struct.pack("<IB", 1 + len(object_id) + len(payload), op) + object_id + payload
        with self._lock:
            self._sock.sendall(msg)
            header = _recv_exact(self._sock, 4)
            (length,) = struct.unpack("<I", header)
            body = _recv_exact(self._sock, length)
        return body[0], body[1:]

    # -- API --

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        """Allocate; returns a writable view. Must call seal() after writing."""
        st, payload = self._request(OP_CREATE, object_id.binary(), struct.pack("<Q", size))
        if st == ST_FULL:
            raise ObjectStoreFullError(f"cannot allocate {size} bytes")
        if st == ST_EXISTS:
            raise ValueError(f"object {object_id} already exists")
        if st != ST_OK:
            raise RuntimeError(f"create failed: status {st}")
        shm_name = payload.decode()
        if size == 0:
            m = _Mapping(memoryview(b""), None)
        else:
            mm = self._map(shm_name, size, writable=True)
            m = _Mapping(memoryview(mm), mm)
        # The writable mapping is NOT published to the get() cache yet —
        # same-process readers must not see unsealed bytes; seal() promotes
        # it. Any stale cached mapping (evict+reconstruct recreates the
        # object under a NEW shm segment) is dropped now so no reader keeps
        # hitting dead pages.
        key = object_id.binary()
        with self._map_lock:
            self._mappings.pop(key, None)  # dropped, not closed: readers may
            #                                still hold exported views
            old_pending = self._pending_creates.pop(key, None)
            self._pending_creates[key] = m
        if old_pending is not None:
            old_pending.close()  # abandoned earlier create by this process
        return m.buf

    def discard_pending(self, object_id: ObjectID) -> None:
        """Drop a created-but-never-sealed mapping (failed write/seal path);
        without this, aborted puts leak writable mmaps outside the LRU cap."""
        with self._map_lock:
            m = self._pending_creates.pop(object_id.binary(), None)
        if m is not None:
            m.close()

    def seal(self, object_id: ObjectID, pin: bool = False) -> None:
        """pin=True seals AND pins atomically (primary copies): the object
        can spill under pressure but never be LRU-evicted until unpinned."""
        st, _ = self._request(
            OP_SEAL, object_id.binary(), b"\x01" if pin else b""
        )
        if st != ST_OK:
            raise RuntimeError(f"seal failed: status {st}")
        key = object_id.binary()
        with self._map_lock:
            m = self._pending_creates.pop(key, None)
        if m is not None:
            self._cache_mapping(key, m, replace=True)

    def get(self, object_id: ObjectID, timeout_ms: int = 0) -> memoryview | None:
        """Zero-copy read view, or None if absent (timeout_ms=0 → no wait).

        Deleted/evicted objects surface PROMPTLY as EVICTED: the daemon
        tombstones on every delete and wakes blocked getters (store.cpp),
        so a get racing a delete returns in one round-trip, not after the
        full timeout. The ``object_store.get`` chaos point fires before
        the local cache is consulted, making store fetch faults (used by
        the KV-handoff chaos tests) injectable like every other RPC."""
        from ray_tpu_torch._private import chaos

        chaos.fire(
            "object_store.get",
            object_id=object_id.hex(),
            timeout_ms=int(timeout_ms),
        )
        key = object_id.binary()
        # Cache hit: the data is immutable and our mmap stays valid even if
        # the server evicts the segment (the kernel keeps mapped pages), so
        # no RPC is needed.
        with self._map_lock:
            cached = self._mappings.get(key)
            if cached is not None:
                self._mappings.move_to_end(key)
                return cached.buf
        # Bounded retry: between the OP_GET reply and our shm_open the
        # server may SPILL the object (unlinking its segment) under memory
        # pressure; a re-request restores it into a fresh segment.
        for _ in range(8):
            st, payload = self._request(OP_GET, key, struct.pack("<Q", timeout_ms))
            if st == ST_NOT_FOUND:
                return None
            if st == ST_EVICTED:
                return EVICTED
            if st == ST_TIMEOUT:
                raise GetTimeoutError(f"get({object_id}) timed out after {timeout_ms}ms")
            if st != ST_OK:
                raise RuntimeError(f"get failed: status {st}")
            (size,) = struct.unpack("<Q", payload[:8])
            shm_name = payload[8:].decode()
            try:
                with self._map_lock:
                    if key in self._mappings:
                        self._mappings.move_to_end(key)
                        return self._mappings[key].buf
                if size == 0:
                    m = _Mapping(memoryview(b""), None)
                else:
                    try:
                        mm = self._map(shm_name, size, writable=False)
                    except FileNotFoundError:
                        continue  # segment spilled mid-handshake: re-request
                    m = _Mapping(memoryview(mm), mm)
                return self._cache_mapping(key, m).buf
            finally:
                # Drop the server-side pin taken by OP_GET as soon as the
                # mmap exists: our mapping keeps the pages valid locally even
                # if the server evicts, and late readers reconstruct from
                # lineage. Pinned bytes on the server thus stay transient.
                self._request(OP_RELEASE, key)
        raise RuntimeError(
            f"get({object_id}): segment vanished {8} times (spill thrash)"
        )

    def _cache_mapping(self, key: bytes, m: _Mapping, replace: bool = False) -> _Mapping:
        """Insert-or-get under the lock; loser of a concurrent double-fetch
        is closed. Returns the canonical mapping for `key`.

        replace=True makes `m` the canonical mapping even if one is cached
        (create() after evict+reconstruct). The displaced mapping is dropped
        without close(): readers may still hold its exported view, and the
        GC closes the mmap once the last view dies."""
        with self._map_lock:
            existing = self._mappings.get(key)
            if existing is not None and replace:
                del self._mappings[key]
                existing = None
            if existing is not None:
                self._mappings.move_to_end(key)
                m.close()
                return existing
            self._mappings[key] = m
            while len(self._mappings) > self.MAX_MAPPINGS:
                _, victim = self._mappings.popitem(last=False)
                victim.close()
            return m

    def release(self, object_id: ObjectID) -> None:
        """Drop the local mapping. Server pins are transient (taken by
        OP_GET, dropped as soon as the mmap exists), so no RPC here."""
        with self._map_lock:
            m = self._mappings.pop(object_id.binary(), None)
        if m is not None:
            m.close()

    def delete(self, object_id: ObjectID) -> None:
        self._request(OP_DELETE, object_id.binary())

    def abort(self, object_id: ObjectID) -> None:
        """Drop an unsealed create server-side (failed write/pull); unlike
        delete() this leaves no eviction tombstone, so a later create of the
        same object succeeds cleanly."""
        self.discard_pending(object_id)
        self._request(OP_ABORT, object_id.binary())

    def wait_objects(
        self, object_ids: list[ObjectID], num_returns: int, timeout_ms: int
    ) -> set[bytes]:
        """BLOCK in the daemon until >= num_returns of object_ids are
        present (or timeout); returns the present subset. Replaces
        client-side contains() busy-polling — the daemon's seal cv wakes
        waiters the moment an object lands. Runs on a CACHED secondary
        connection (one per concurrently-blocked waiter, pooled and
        reused) so it never stalls this client's request socket and
        looping waiters don't churn daemon threads."""
        ids = [o.binary() for o in object_ids]
        payload = struct.pack("<QII", timeout_ms, num_returns, len(ids)) + b"".join(ids)
        msg = struct.pack("<IB", 1 + 28 + len(payload), OP_WAIT) + b"\x00" * 28 + payload
        sock = self._checkout_wait_sock()
        try:
            sock.sendall(msg)
            header = _recv_exact(sock, 4)
            (length,) = struct.unpack("<I", header)
            body = _recv_exact(sock, length)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._checkin_wait_sock(sock)
        if body[0] != ST_OK:
            raise RuntimeError(f"wait failed: status {body[0]}")
        (m,) = struct.unpack_from("<I", body, 1)
        return {body[5 + i * 28 : 5 + (i + 1) * 28] for i in range(m)}

    def pin(self, object_id: ObjectID) -> bool:
        """Long-lived reference (primary-copy pin): the object may spill
        under pressure but can never be LRU-evicted while pinned."""
        st, _ = self._request(OP_PIN, object_id.binary())
        return st == ST_OK

    def unpin(self, object_id: ObjectID) -> None:
        self._request(OP_UNPIN, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        st, _ = self._request(OP_CONTAINS, object_id.binary())
        return st == ST_OK

    def status(self, object_id: ObjectID) -> str:
        """'present' | 'missing' | 'evicted' — without pinning the object."""
        st, _ = self._request(OP_CONTAINS, object_id.binary())
        if st == ST_OK:
            return "present"
        if st == ST_EVICTED:
            return "evicted"
        return "missing"

    def list_objects(self) -> list[ObjectID]:
        st, payload = self._request(OP_LIST, b"\x00" * 28)
        (n,) = struct.unpack("<I", payload[:4])
        out = []
        for i in range(n):
            out.append(ObjectID(payload[4 + i * 28 : 4 + (i + 1) * 28]))
        return out

    def stats(self) -> dict:
        _, payload = self._request(OP_STATS, b"\x00" * 28)
        used, cap, count = struct.unpack("<QQQ", payload)
        return {"used_bytes": used, "capacity_bytes": cap, "num_objects": count}

    def shutdown_store(self) -> None:
        try:
            self._request(OP_SHUTDOWN, b"\x00" * 28)
        except ConnectionError:
            pass

    def close(self) -> None:
        with self._map_lock:
            mappings = list(self._mappings.values())
            self._mappings.clear()
        for m in mappings:
            m.close()
        with self._wait_lock:
            socks, self._wait_socks = self._wait_socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        self._sock.close()

    @staticmethod
    def _map(shm_name: str, size: int, writable: bool) -> mmap.mmap:
        fd = os.open("/dev/shm" + shm_name, os.O_RDWR if writable else os.O_RDONLY)
        try:
            prot = mmap.PROT_READ | (mmap.PROT_WRITE if writable else 0)
            return mmap.mmap(fd, size, prot=prot)
        finally:
            os.close(fd)


class StoreEventSubscriber:
    """Push stream of seal/evict events from the store daemon — the analog
    of plasma's notification socket (reference: plasma clients subscribe for
    sealed-object notifications; the raylet feeds the object directory from
    it). callback(event: int, object_id_bytes: bytes) runs on the reader
    thread; it must be quick or hand off."""

    def __init__(self, socket_path: str, callback):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(socket_path)
        self._callback = callback
        self._closed = threading.Event()
        msg = struct.pack("<IB", 1 + 28, OP_SUBSCRIBE) + b"\x00" * 28
        self._sock.sendall(msg)
        header = _recv_exact(self._sock, 4)
        (length,) = struct.unpack("<I", header)
        body = _recv_exact(self._sock, length)
        if body[0] != ST_OK:
            raise RuntimeError(f"store subscribe failed: status {body[0]}")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="store-events"
        )
        self._thread.start()

    def _loop(self) -> None:
        try:
            while not self._closed.is_set():
                header = _recv_exact(self._sock, 4)
                (length,) = struct.unpack("<I", header)
                body = _recv_exact(self._sock, length)
                try:
                    self._callback(body[0], body[1:29])
                except Exception:  # noqa: BLE001 — subscriber must survive
                    pass
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
