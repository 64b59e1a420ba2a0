"""ctypes loader for the native KV store (``native/pskv.cpp``) and the
flat vector index of the router's semantic cache
(``native/vecindex.cpp``), the port's own copy of
``production_stack_tpu/kvcache/_native.py`` (the store and index
functions; the in-process server entry points are left out, the cache
server runs as ``pskv-server``).

Looks for ``native/build/libpskv.so`` at the repository root and builds
it with ``native/Makefile`` on first use where a toolchain is present
(``PSKV_NO_BUILD`` set: never build). Where the library is unavailable,
``store.HostMemoryStore`` takes the pure-Python LRU instead: that choice
is the host store's backend and never touches the device.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libpskv.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int
    p, cp = ctypes.c_void_p, ctypes.c_char_p
    lib.pskv_store_new.restype = p
    lib.pskv_store_new.argtypes = [u64]
    lib.pskv_store_free.restype = None
    lib.pskv_store_free.argtypes = [p]
    lib.pskv_store_put.restype = i32
    lib.pskv_store_put.argtypes = [p, cp, ctypes.c_uint32, cp, u64]
    lib.pskv_store_get_size.restype = i64
    lib.pskv_store_get_size.argtypes = [p, cp, ctypes.c_uint32]
    lib.pskv_store_get.restype = i64
    lib.pskv_store_get.argtypes = [p, cp, ctypes.c_uint32,
                                   ctypes.c_char_p, u64]
    lib.pskv_store_exists.restype = i32
    lib.pskv_store_exists.argtypes = [p, cp, ctypes.c_uint32]
    lib.pskv_store_del.restype = i32
    lib.pskv_store_del.argtypes = [p, cp, ctypes.c_uint32]
    lib.pskv_store_clear.restype = None
    lib.pskv_store_clear.argtypes = [p]
    for name in ("bytes", "count", "hits", "misses", "evictions"):
        fn = getattr(lib, f"pskv_store_{name}")
        fn.restype = u64
        fn.argtypes = [p]
    # psvi_*: flat inner-product vector index (native/vecindex.cpp),
    # consumed by router/semantic_cache.py
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.psvi_new.restype = p
    lib.psvi_new.argtypes = [i32]
    lib.psvi_free.restype = None
    lib.psvi_free.argtypes = [p]
    lib.psvi_dim.restype = i32
    lib.psvi_dim.argtypes = [p]
    lib.psvi_size.restype = u64
    lib.psvi_size.argtypes = [p]
    lib.psvi_add.restype = i32
    lib.psvi_add.argtypes = [p, fp, ctypes.c_int64]
    lib.psvi_remove.restype = i32
    lib.psvi_remove.argtypes = [p, ctypes.c_int64]
    lib.psvi_search.restype = i32
    lib.psvi_search.argtypes = [p, fp, i32, fp, ip]
    lib.psvi_save.restype = i32
    lib.psvi_save.argtypes = [p, cp]
    lib.psvi_load.restype = p
    lib.psvi_load.argtypes = [cp]
    return lib


def _make(*make_args: str) -> bool:
    if os.environ.get("PSKV_NO_BUILD"):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, *make_args],
                       capture_output=True, timeout=120, check=True)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when unavailable (cached)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _make("build/libpskv.so")
        try:
            _lib = _configure(ctypes.CDLL(_LIB_PATH))
        except AttributeError:
            # a stale library (the build directory is gitignored and
            # survives checkouts) lacks a symbol: rebuild it and map the
            # new one from a fresh copy, since dlopen caches by path
            _lib = None
            _load_failed = True
            if _make("-B", "build/libpskv.so"):
                fd, tmp = tempfile.mkstemp(suffix=".so", prefix="libpskv-")
                os.close(fd)
                try:
                    shutil.copyfile(_LIB_PATH, tmp)
                    _lib = _configure(ctypes.CDLL(tmp))
                    _load_failed = False
                except (OSError, AttributeError):
                    pass
                finally:
                    os.unlink(tmp)
        except OSError:
            _load_failed = True
        return _lib


def server_binary() -> Optional[str]:
    """Path to the standalone pskv-server binary, building it if needed;
    None where it cannot be built."""
    path = os.path.join(_NATIVE_DIR, "build", "pskv-server")
    if not os.path.exists(path):
        _make("build/pskv-server")
    return path if os.path.exists(path) else None


class NativeLruStore:
    """Byte-bounded LRU of the C store (owns the handle)."""

    def __init__(self, capacity_bytes: int, lib: Optional[ctypes.CDLL] = None):
        self._lib = lib or load()
        if self._lib is None:
            raise RuntimeError("libpskv.so unavailable")
        self._h = self._lib.pskv_store_new(capacity_bytes)

    def put(self, key: bytes, val: bytes) -> bool:
        return self._lib.pskv_store_put(self._h, key, len(key), val,
                                        len(val)) == 0

    def get(self, key: bytes) -> Optional[bytes]:
        # size query, then copy; retried when the value is replaced by a
        # larger one between the two calls (rc -2)
        for _ in range(4):
            n = self._lib.pskv_store_get_size(self._h, key, len(key))
            if n < 0:
                return None
            buf = ctypes.create_string_buffer(n)
            rc = self._lib.pskv_store_get(self._h, key, len(key), buf, n)
            if rc >= 0:
                return buf.raw[:rc]
        return None

    def exists(self, key: bytes) -> bool:
        return bool(self._lib.pskv_store_exists(self._h, key, len(key)))

    def delete(self, key: bytes) -> bool:
        return bool(self._lib.pskv_store_del(self._h, key, len(key)))

    def clear(self) -> None:
        self._lib.pskv_store_clear(self._h)

    def stats(self) -> dict:
        return {name: getattr(self._lib, f"pskv_store_{name}")(self._h)
                for name in ("bytes", "count", "hits", "misses",
                             "evictions")}

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.pskv_store_free(h)
            self._h = None
