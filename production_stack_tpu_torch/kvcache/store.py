"""Tiered byte stores for KV chunks
(``production_stack_tpu/kvcache/store.py``).

Host DRAM (``HostMemoryStore``, the native C++ LRU of
``native/pskv.cpp`` where it builds, else a Python LRU), local disk
(``DiskStore``) and a remote shared cache server (``RemoteStore``, the
TPKV protocol of protocol.py). Values are opaque bytes (the connector
serializes KV chunks, connector.py); the stores compose as

    TieredStore([HostMemoryStore, DiskStore, RemoteStore])

whose get() probes tiers in order and promotes hits into the faster
tiers, and whose put() writes through to every tier. Nothing here
touches a device.
"""

import collections
import os
import socket
import threading
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from production_stack_tpu_torch.kvcache import protocol
from production_stack_tpu_torch.kvcache._native import (NativeLruStore,
                                                       load)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class KVStore(ABC):
    """get/put/exists/delete over opaque byte values."""

    #: short name used as the ``tier`` label on occupancy gauges
    tier_name = "unknown"

    @abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    def get_with_tier(self, key: bytes):
        """``(value, tier_name_that_served_it)`` — single stores serve
        from themselves; TieredStore reports the tier that actually hit
        (the connector's per-tier hit attribution)."""
        return self.get(key), self.tier_name

    @abstractmethod
    def put(self, key: bytes, val: bytes) -> bool: ...

    @abstractmethod
    def exists(self, key: bytes) -> bool: ...

    @abstractmethod
    def delete(self, key: bytes) -> bool: ...

    def stats(self) -> Dict[str, int]:
        return {}

    def tier_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tier occupancy: {tier_name: stats}. Single stores report
        themselves; TieredStore fans out."""
        return {self.tier_name: self.stats()}

    def close(self) -> None:
        pass


class _PyLruStore:
    """Byte-bounded LRU on OrderedDict — fallback when libpskv is absent."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._data: "collections.OrderedDict[bytes, bytes]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._hits = self._misses = self._evictions = 0
        self._lock = threading.Lock()

    def put(self, key: bytes, val: bytes) -> bool:
        with self._lock:
            if len(val) > self.capacity:
                return False
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._data[key] = val
            self._bytes += len(val)
            while self._bytes > self.capacity and self._data:
                _, evicted = self._data.popitem(last=False)
                self._bytes -= len(evicted)
                self._evictions += 1
            return True

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self._misses += 1
                return None
            self._data.move_to_end(key)
            self._hits += 1
            return val

    def exists(self, key: bytes) -> bool:
        with self._lock:
            return key in self._data

    def delete(self, key: bytes) -> bool:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            return old is not None

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": self._bytes, "count": len(self._data),
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions}


class HostMemoryStore(KVStore):
    """Host-DRAM tier (the LMCACHE_LOCAL_CPU equivalent), native-backed.

    The configured byte budget is a hard bound enforced by LRU eviction
    (both backends), so a long soak can grow the tier only up to
    ``capacity_bytes`` — never into the host OOM killer."""

    tier_name = "cpu"

    def __init__(self, capacity_bytes: int, force_python: bool = False):
        self.capacity = capacity_bytes
        if not force_python and load() is not None:
            self._impl = NativeLruStore(capacity_bytes)
            self.backend = "native"
        else:
            self._impl = _PyLruStore(capacity_bytes)
            self.backend = "python"

    def get(self, key: bytes) -> Optional[bytes]:
        return self._impl.get(key)

    def put(self, key: bytes, val: bytes) -> bool:
        return bool(self._impl.put(key, val))

    def exists(self, key: bytes) -> bool:
        return self._impl.exists(key)

    def delete(self, key: bytes) -> bool:
        return self._impl.delete(key)

    def clear(self) -> None:
        self._impl.clear()

    def stats(self) -> Dict[str, int]:
        out = dict(self._impl.stats())
        out.setdefault("capacity", self.capacity)
        return out


class DiskStore(KVStore):
    """Local-disk tier (the LMCACHE_LOCAL_DISK equivalent).

    One file per chunk under `root`, LRU by mtime, byte-bounded. Writes are
    tmp-file + rename so a crash never leaves a torn chunk visible.
    Occupancy is accounted incrementally (seeded by one startup scan) so
    ``stats()`` — polled by /load and /metrics — never walks the
    directory on the serving path.
    """

    tier_name = "disk"

    def __init__(self, root: str, capacity_bytes: int = 1 << 34):
        self.root = root
        self.capacity = capacity_bytes
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._bytes, self._count = self._scan()

    def _scan(self):
        total = count = 0
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if e.name.endswith(".kv"):
                        count += 1
                        total += e.stat().st_size
        except OSError:
            pass
        return total, count

    def _path(self, key: bytes) -> str:
        return os.path.join(self.root, key.hex() + ".kv")

    def get(self, key: bytes) -> Optional[bytes]:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
            os.utime(path)  # LRU touch
            return data
        except OSError:
            return None

    def put(self, key: bytes, val: bytes) -> bool:
        if len(val) > self.capacity:
            return False
        path = self._path(key)
        # per-writer tmp name: concurrent same-key PUTs (the threaded
        # --disk-path cache server) each write their own file and race
        # only on the atomic rename — last writer wins with a FULL
        # value, never interleaved bytes
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(val)
        except OSError:
            return False
        # stat + replace + accounting are one atomic step: a racing
        # delete() (prefetch-side eviction of a poisoned chunk) between
        # them would otherwise leave _bytes under-counted and eviction
        # deferred past the configured budget
        with self._lock:
            try:
                old = os.stat(path).st_size
            except OSError:
                old = -1          # new key
            try:
                os.replace(tmp, path)
            except OSError:
                try:
                    os.remove(tmp)     # never leak a stray tmp
                except OSError:
                    pass
                return False
            self._bytes += len(val) - max(old, 0)
            if old < 0:
                self._count += 1
        self._evict()
        return True

    def exists(self, key: bytes) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: bytes) -> bool:
        path = self._path(key)
        with self._lock:
            try:
                size = os.stat(path).st_size
                os.remove(path)
            except OSError:
                return False
            self._bytes -= size
            self._count -= 1
        return True

    def _evict(self) -> None:
        with self._lock:
            if self._bytes <= self.capacity:
                return
            try:
                entries = []
                total = 0
                with os.scandir(self.root) as it:
                    for e in it:
                        if not e.name.endswith(".kv"):
                            continue
                        st = e.stat()
                        entries.append((st.st_mtime, st.st_size, e.path))
                        total += st.st_size
                entries.sort()  # oldest first
                removed_b = removed_n = 0
                for _, size, path in entries:
                    if total - removed_b <= self.capacity:
                        break
                    try:
                        os.remove(path)
                        removed_b += size
                        removed_n += 1
                    except OSError:
                        pass
                # re-anchor on the scan (heals drift from external
                # deletions too)
                self._bytes = total - removed_b
                self._count = len(entries) - removed_n
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": self._bytes, "count": self._count,
                    "capacity": self.capacity}


class RemoteStore(KVStore):
    """TPKV client tier (the LMCACHE_REMOTE_URL equivalent).

    Synchronous socket client with lazy (re)connect and one connection *per
    calling thread* (threading.local): the KV writer thread pushes
    multi-megabyte chunk batches, and serializing the admission-path
    prefetch reads behind those writes would add the write time straight to
    TTFT on cache hits.

    Failure behavior is *bounded and breaker-guarded*: every operation is
    soft (a dead or hung cache server degrades to a miss/no-op inside
    ``connect_timeout``/``io_timeout``), and after
    ``breaker_threshold`` consecutive failures the store short-circuits
    every call for ``breaker_cooldown_s`` — a sick cache server costs
    each request at most the breaker probe, never a per-chunk timeout
    walk on the TTFT path.
    """

    tier_name = "remote"

    def __init__(self, url: str, connect_timeout: float = 5.0,
                 io_timeout: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 10.0):
        self.host, self.port = protocol.parse_url(url)
        self.url = url
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self.breaker_threshold = max(1, breaker_threshold)
        self.breaker_cooldown_s = breaker_cooldown_s
        self._fail_lock = threading.Lock()
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._breaker_trips = 0
        self._local = threading.local()
        self._all_socks: List[socket.socket] = []
        self._all_lock = threading.Lock()

    # -- breaker --------------------------------------------------------

    def breaker_open(self) -> bool:
        """True while calls are being short-circuited. The first caller
        past the cooldown closes the window and probes for real."""
        import time
        with self._fail_lock:
            return time.monotonic() < self._open_until

    def _record_failure(self) -> None:
        import time
        with self._fail_lock:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.breaker_threshold:
                self._open_until = time.monotonic() + \
                    self.breaker_cooldown_s
                self._breaker_trips += 1
                self._consecutive_failures = 0
                logger.warning(
                    "remote KV %s breaker open for %.1fs (%d consecutive "
                    "failures)", self.url, self.breaker_cooldown_s,
                    self.breaker_threshold)

    def _record_success(self) -> None:
        with self._fail_lock:
            self._consecutive_failures = 0

    def _connect(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout)
            sock.settimeout(self.io_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
            with self._all_lock:
                self._all_socks.append(sock)
        return sock

    def _drop(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            with self._all_lock:
                if sock in self._all_socks:
                    self._all_socks.remove(sock)
            self._local.sock = None

    def _recv_all(self, sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("remote KV server closed connection")
            buf.extend(part)
        return bytes(buf)

    def _call(self, op: int, key: bytes = b"", val: bytes = b""):
        """-> (status, payload); one reconnect retry on a dead socket.
        Thread-safe: each thread drives its own connection. Raises
        ConnectionError immediately while the breaker is open."""
        if self.breaker_open():
            raise ConnectionError(f"remote KV {self.url} breaker open")
        for attempt in (0, 1):
            try:
                sock = self._connect()
                sock.sendall(protocol.encode_request(op, key, val))
                hdr = self._recv_all(sock, protocol.RESP_HDR_SIZE)
                status, vlen = protocol.decode_response_header(hdr)
                payload = self._recv_all(sock, vlen) if vlen else b""
                self._record_success()
                return status, payload
            except (OSError, ConnectionError) as e:
                self._drop()
                if attempt:
                    self._record_failure()
                    logger.warning("remote KV %s unreachable: %s",
                                   self.url, e)
                    raise
        raise ConnectionError("unreachable")  # not reached

    def get(self, key: bytes) -> Optional[bytes]:
        try:
            status, payload = self._call(protocol.OP_GET, key)
        except (OSError, ConnectionError):
            return None
        return payload if status == protocol.STATUS_OK else None

    def put(self, key: bytes, val: bytes) -> bool:
        try:
            status, _ = self._call(protocol.OP_PUT, key, val)
            return status == protocol.STATUS_OK
        except (OSError, ConnectionError):
            return False

    def exists(self, key: bytes) -> bool:
        try:
            status, _ = self._call(protocol.OP_EXISTS, key)
            return status == protocol.STATUS_OK
        except (OSError, ConnectionError):
            return False

    def delete(self, key: bytes) -> bool:
        try:
            status, _ = self._call(protocol.OP_DEL, key)
            return status == protocol.STATUS_OK
        except (OSError, ConnectionError):
            return False

    def ping(self) -> bool:
        try:
            status, payload = self._call(protocol.OP_PING)
            return status == protocol.STATUS_OK and payload == b"pong"
        except (OSError, ConnectionError):
            return False

    def stats(self) -> Dict[str, int]:
        import json
        out: Dict[str, int] = {}
        try:
            status, payload = self._call(protocol.OP_STATS)
            if status == protocol.STATUS_OK:
                out = json.loads(payload)
        except (OSError, ConnectionError, ValueError):
            pass
        import time
        with self._fail_lock:
            out["breaker_open"] = int(time.monotonic() < self._open_until)
            out["breaker_trips"] = self._breaker_trips
        return out

    def tier_stats(self) -> Dict[str, Dict[str, int]]:
        """Local-only view (NO network round trip — tier_stats feeds
        load_report, which runs per response): breaker state here, the
        server's own occupancy on the server's side."""
        import time
        with self._fail_lock:
            return {self.tier_name: {
                "breaker_open": int(time.monotonic() < self._open_until),
                "breaker_trips": self._breaker_trips}}

    def close(self) -> None:
        with self._all_lock:
            for sock in self._all_socks:
                try:
                    sock.close()
                except OSError:
                    pass
            self._all_socks.clear()


class TieredStore(KVStore):
    """Probe-in-order composition with hit promotion and write-through."""

    def __init__(self, tiers: List[KVStore]):
        if not tiers:
            raise ValueError("TieredStore needs at least one tier")
        self.tiers = tiers

    def get(self, key: bytes) -> Optional[bytes]:
        return self.get_with_tier(key)[0]

    def get_with_tier(self, key: bytes):
        for i, tier in enumerate(self.tiers):
            val = tier.get(key)
            if val is not None:
                for faster in self.tiers[:i]:  # promote
                    faster.put(key, val)
                return val, tier.tier_name
        return None, None

    def put(self, key: bytes, val: bytes) -> bool:
        ok = False
        for tier in self.tiers:
            ok = tier.put(key, val) or ok
        return ok

    def exists(self, key: bytes) -> bool:
        return any(tier.exists(key) for tier in self.tiers)

    def delete(self, key: bytes) -> bool:
        deleted = False
        for tier in self.tiers:
            deleted = tier.delete(key) or deleted
        return deleted

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i, tier in enumerate(self.tiers):
            for k, v in tier.stats().items():
                out[f"tier{i}_{type(tier).__name__}_{k}"] = v
        return out

    def tier_stats(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for tier in self.tiers:
            out.update(tier.tier_stats())
        return out

    def close(self) -> None:
        for tier in self.tiers:
            tier.close()


def make_store(local_cpu_bytes: int = 0, local_disk_path: Optional[str] = None,
               local_disk_bytes: int = 1 << 34,
               remote_url: Optional[str] = None,
               remote_connect_timeout_s: float = 2.0,
               remote_io_timeout_s: float = 5.0,
               remote_breaker_threshold: int = 3,
               remote_breaker_cooldown_s: float = 10.0
               ) -> Optional[KVStore]:
    """Build the tier stack from config; None when all tiers are off."""
    tiers: List[KVStore] = []
    if local_cpu_bytes > 0:
        tiers.append(HostMemoryStore(local_cpu_bytes))
    if local_disk_path:
        tiers.append(DiskStore(local_disk_path, local_disk_bytes))
    if remote_url:
        tiers.append(RemoteStore(
            remote_url,
            connect_timeout=remote_connect_timeout_s,
            io_timeout=remote_io_timeout_s,
            breaker_threshold=remote_breaker_threshold,
            breaker_cooldown_s=remote_breaker_cooldown_s))
    if not tiers:
        return None
    return tiers[0] if len(tiers) == 1 else TieredStore(tiers)
