"""Pipelined tier reads for the consumer prefetch walk
(``production_stack_tpu/kvcache/pipeline.py``).

A serial walk with one wall-clock budget lets the first slow chunk
consume the entire ``prefetch_timeout_s``: every later chunk breaks at
the wall having never been tried, so a slow-not-dead tier serializes
straight into TTFT. Two remedies:

1. **Pipelining** — up to ``workers`` chunk reads are in flight at
   once (a bounded submit window ahead of the in-order consumer), so
   tier latency overlaps tier latency: while chunk ``i`` is still on
   the wire, ``i+1 .. i+window`` are already being read. Results are
   consumed strictly in key order (the chain property: chunk ``i+1``
   is useless without ``i``), and the walk still stops at the first
   miss. Remote reads parallelize naturally — ``RemoteStore`` holds
   per-thread sockets.

2. **Per-chunk deadline accounting** (the budget fix) — chunk ``i`` of
   ``n`` must complete by ``t0 + budget * (i+1) / n``: a cumulative
   fair-share deadline instead of one shared wall. A single stalled
   chunk is now abandoned after roughly ``budget / n`` (plus whatever
   slack faster earlier chunks banked), instead of eating the whole
   budget; a uniformly slow tier keeps all of its budget because early
   chunks that finish fast roll their slack forward. The total wall
   stays <= ``budget`` — the per-chunk deadlines are monotone and the
   last one IS the old wall.

A fetch abandoned on deadline keeps running on its pool thread until
the store's own per-op timeout fires (the threads are few and the
store ops are individually bounded); its result is discarded.
"""

import concurrent.futures
import time
from typing import Callable, List, Optional, Tuple

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class WalkStats:
    """What one pipelined walk did (folded into connector counters)."""

    __slots__ = ("deadline_hits", "chunk_deadline_hits",
                 "pipelined_fetches", "wait_s")

    def __init__(self):
        self.deadline_hits = 0          # whole-walk budget exhausted
        self.chunk_deadline_hits = 0    # one chunk blew its fair share
        self.pipelined_fetches = 0      # reads issued ahead of consume
        self.wait_s = 0.0


class PipelinedFetcher:
    """A small shared thread pool + the in-order fair-deadline walk."""

    def __init__(self, workers: int = 4):
        self.workers = max(1, int(workers))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="kv-prefetch")

    def fetch_walk(self, keys: List[bytes],
                   get_fn: Callable[[bytes], Tuple[Optional[bytes],
                                                   Optional[str]]],
                   budget_s: float,
                   ) -> Tuple[List[Tuple[bytes, bytes, Optional[str]]],
                              WalkStats]:
        """Walk ``keys`` in order; return ``[(key, val, tier)]`` for
        the leading run of hits plus walk stats. Stops at the first
        miss, error, or blown deadline."""
        stats = WalkStats()
        t0 = time.monotonic()
        n = len(keys)
        if n == 0:
            return [], stats
        window = min(self.workers * 2, n)
        futures = {}

        def submit(i: int) -> None:
            futures[i] = self._pool.submit(get_fn, keys[i])

        for i in range(window):
            submit(i)
        stats.pipelined_fetches = window - 1
        results: List[Tuple[bytes, bytes, Optional[str]]] = []
        try:
            for i in range(n):
                chunk_deadline = t0 + budget_s * (i + 1) / n
                timeout = chunk_deadline - time.monotonic()
                if timeout <= 0:
                    stats.deadline_hits += 1
                    break
                try:
                    val, tier = futures[i].result(timeout=timeout)
                except concurrent.futures.TimeoutError:
                    stats.chunk_deadline_hits += 1
                    break
                except Exception as e:  # a sick tier reads as a miss
                    logger.warning("KV prefetch read failed: %s", e)
                    break
                if val is None:
                    break
                results.append((keys[i], val, tier))
                nxt = i + window
                if nxt < n:
                    submit(nxt)
                    stats.pipelined_fetches += 1
        finally:
            for f in futures.values():
                f.cancel()
        stats.wait_s = time.monotonic() - t0
        return results, stats

    def close(self) -> None:
        self._pool.shutdown(wait=False)
