"""Standalone TPKV cache server
(``python -m production_stack_tpu_torch.kvcache.server --port P``), the
port's copy of ``production_stack_tpu/kvcache/server.py``: the shared
remote tier that producer and consumer engines (of either package) read
and write. Two implementations serve the one wire protocol:

  * native: the C++ ``pskv-server`` binary built from ``native/`` (the
    default where it builds): store and transport never touch Python;
  * asyncio: a Python front-end over HostMemoryStore (with an optional
    disk spill tier), where no toolchain exists (``--backend python``).
"""

import argparse
import asyncio
import os
import signal
from typing import Optional

from production_stack_tpu_torch.kvcache import protocol
from production_stack_tpu_torch.kvcache._native import server_binary
from production_stack_tpu_torch.kvcache.store import HostMemoryStore
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class CacheServer:
    """Asyncio TPKV server over a HostMemoryStore (+ optional disk spill).

    Write atomicity: a PUT mutates the store only after the ENTIRE value
    frame has been received (``readexactly``) — a replica killed
    mid-publish tears the connection, not the shared tier. Concurrent same-key PUTs are last-writer-wins
    full-value swaps: memory-tier puts replace under the store lock, and
    the disk tier writes tmp-file + rename. Consumers additionally
    validate a full-chunk checksum (kvcache/connector.py), so even a
    corrupt value degrades to a miss, never to poisoned KV.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 8100,
                 capacity_bytes: int = 4 << 30,
                 disk_path: Optional[str] = None,
                 disk_capacity_bytes: int = 1 << 34):
        self.host, self.port = host, port
        self.store = HostMemoryStore(capacity_bytes)
        # with a disk tier, store ops do real file I/O (plus eviction
        # scans) — run them on worker threads so one replica's publish
        # burst can never stall every other client's GET on the event
        # loop (the stores are lock-protected and thread-safe)
        self._offload_ops = bool(disk_path)
        if disk_path:
            from production_stack_tpu_torch.kvcache.store import (DiskStore,
                                                            TieredStore)
            self.store = TieredStore([self.store,
                                      DiskStore(disk_path,
                                                disk_capacity_bytes)])
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        logger.info("TPKV cache server on %s:%d (backend=%s, tiers=%s)",
                    self.host, self.port,
                    getattr(self.store, "backend", "tiered"),
                    list(self.store.tier_stats()))

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    hdr = await reader.readexactly(protocol.REQ_HDR_SIZE)
                except asyncio.IncompleteReadError:
                    break
                op, klen, vlen = protocol.decode_request_header(hdr)
                key = await reader.readexactly(klen) if klen else b""
                val = await reader.readexactly(vlen) if vlen else b""
                if self._offload_ops:
                    resp = await asyncio.to_thread(self._dispatch, op,
                                                   key, val)
                else:
                    resp = self._dispatch(op, key, val)
                writer.write(resp)
                await writer.drain()
        except (ValueError, ConnectionError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _dispatch(self, op: int, key: bytes, val: bytes) -> bytes:
        enc, P = protocol.encode_response, protocol
        if op == P.OP_PUT:
            return enc(P.STATUS_OK if self.store.put(key, val)
                       else P.STATUS_ERROR)
        if op == P.OP_GET:
            data = self.store.get(key)
            return enc(P.STATUS_MISSING) if data is None \
                else enc(P.STATUS_OK, data)
        if op == P.OP_EXISTS:
            return enc(P.STATUS_OK if self.store.exists(key)
                       else P.STATUS_MISSING)
        if op == P.OP_DEL:
            self.store.delete(key)
            return enc(P.STATUS_OK)
        if op == P.OP_STATS:
            import json
            return enc(P.STATUS_OK,
                       json.dumps(self.store.stats()).encode())
        if op == P.OP_PING:
            return enc(P.STATUS_OK, b"pong")
        return enc(P.STATUS_ERROR)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="TPKV shared cache server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--capacity-gb", type=float, default=4.0)
    parser.add_argument("--disk-path", default=None,
                        help="spill tier: evicted/overflow chunks "
                             "persist here (tmp-file + rename writes; "
                             "python backend only)")
    parser.add_argument("--disk-gb", type=float, default=16.0)
    parser.add_argument("--backend", choices=["auto", "native", "python"],
                        default="auto",
                        help="native = exec the C++ pskv-server binary")
    args = parser.parse_args(argv)

    if args.backend == "native" and args.disk_path:
        logger.error("--disk-path requires --backend python (the native "
                     "pskv-server is memory-only)")
        return 1
    if args.backend in ("auto", "native") and not args.disk_path:
        binary = server_binary()
        if binary is not None:
            os.execv(binary, [binary, "--host", args.host,
                              "--port", str(args.port),
                              "--capacity-gb", str(args.capacity_gb)])
        if args.backend == "native":
            logger.error("native pskv-server binary unavailable")
            return 1

    server = CacheServer(args.host, args.port,
                         int(args.capacity_gb * (1 << 30)),
                         disk_path=args.disk_path,
                         disk_capacity_bytes=int(args.disk_gb * (1 << 30)))
    loop = asyncio.new_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, loop.stop)
    loop.run_until_complete(server.start())
    try:
        loop.run_forever()
    finally:
        loop.run_until_complete(server.stop())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
