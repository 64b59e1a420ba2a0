"""AsyncLLMEngine: asyncio facade over the synchronous engine loop
(``production_stack_tpu/engine/async_engine.py``).

The engine loop runs on one dedicated thread; results cross into the
event loop via ``loop.call_soon_threadsafe`` onto per-request asyncio
queues. When idle the loop parks on a condition variable.

Where the JAX engine logs a failed step and carries on, this one stops:
the failure is delivered to every in-flight request as an
``EngineDeadError``, the loop ends, and later submissions raise the same
error. A step that failed on the card leaves the pool and the decode
carry in an unknown state, so carrying on would serve garbage or spin.

``submit`` raises what ``add_request`` raises (``AdmissionRejected``
when the waiting queue is full, ValueError for a bad option) to the
server, and carries the request's deadline into the engine.
"""

import asyncio
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Dict, List, Optional, Tuple

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine, StepOutput
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class EngineDeadError(RuntimeError):
    """An engine step failed; the engine loop has stopped."""


class AsyncLLMEngine:
    def __init__(self, cfg: EngineConfig, params=None, mesh=None):
        self.engine = LLMEngine(cfg, params=params, mesh=mesh)
        self._queues: Dict[str, asyncio.Queue] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # the step failure that stopped the loop, if any
        self.failure: Optional[BaseException] = None
        # calls that wait on the engine lock (add_request/abort) run
        # here, off the event loop
        self._lock_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="engine-lock")

    # ------------------------------------------------------------------

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None,
              warmup: bool = True) -> None:
        self._loop = loop or asyncio.get_event_loop()
        if self._lock_pool._shutdown:    # restarted after stop()
            self._lock_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="engine-lock")
        if warmup:
            self.engine.runner.warmup()
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-loop")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        with self._wake:
            self._wake.notify_all()
        if self._thread:
            self._thread.join(timeout=30)
        self._lock_pool.shutdown(wait=False)

    def _run(self) -> None:
        while self._running:
            if not self.engine.has_work:
                with self._wake:
                    if not self.engine.has_work and self._running:
                        self._wake.wait(timeout=0.2)
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:  # noqa: BLE001 — delivered, not lost
                logger.exception("engine step failed: failing every "
                                 "in-flight request and stopping the "
                                 "engine loop")
                self.failure = e
                self._running = False
                if self._loop is not None:
                    self._loop.call_soon_threadsafe(self._fail_all, e)
                return
            if outputs and self._loop is not None:
                self._loop.call_soon_threadsafe(self._dispatch, outputs)

    def _dispatch(self, outputs: List[StepOutput]) -> None:
        for out in outputs:
            q = self._queues.get(out.seq_id)
            if q is not None:
                q.put_nowait(out)
                if out.finished:
                    self._queues.pop(out.seq_id, None)

    def _fail_all(self, cause: BaseException) -> None:
        err = EngineDeadError(f"engine step failed: {cause!r}")
        err.__cause__ = cause
        for q in self._queues.values():
            q.put_nowait(err)
        self._queues.clear()

    def _check_alive(self) -> None:
        if self.failure is not None:
            raise EngineDeadError(
                f"engine stopped after a failed step: {self.failure!r}")

    # ------------------------------------------------------------------

    async def submit(self, prompt_tokens: List[int],
                     options: SamplingOptions,
                     seq_id: Optional[str] = None,
                     model: Optional[str] = None,
                     deadline: Optional[float] = None
                     ) -> Tuple[str, asyncio.Queue]:
        """Queue a request; returns (seq_id, result queue). add_request
        takes the engine lock, held across whole steps, so it runs on
        an executor thread. The queue exists before the engine can emit
        its first output."""
        self._check_alive()
        seq_id = seq_id or f"seq-{uuid.uuid4().hex[:12]}"
        if seq_id in self._queues:
            raise ValueError(f"seq_id {seq_id!r} already has a live stream")
        q: asyncio.Queue = asyncio.Queue()
        self._queues[seq_id] = q
        loop = asyncio.get_running_loop()
        try:
            cfut = self._lock_pool.submit(
                lambda: self.engine.add_request(
                    prompt_tokens, options, seq_id=seq_id, model=model,
                    deadline=deadline))
        except RuntimeError:
            self._queues.pop(seq_id, None)
            raise
        try:
            await asyncio.wrap_future(cfut, loop=loop)
        except asyncio.CancelledError:
            # add_request may still complete after the cancellation:
            # abort the sequence once it settles
            self._queues.pop(seq_id, None)

            def _cleanup(f):
                if f.cancelled() or f.exception() is not None:
                    return
                try:
                    self._lock_pool.submit(self.engine.abort, seq_id)
                except RuntimeError:
                    self.engine.abort(seq_id)
            cfut.add_done_callback(_cleanup)
            raise
        except Exception:
            self._queues.pop(seq_id, None)
            raise
        with self._wake:
            self._wake.notify_all()
        return seq_id, q

    def abort(self, seq_id: str) -> None:
        """Abort a live request: the queue registration goes at once,
        the engine-side abort (which waits on the engine lock) runs on
        an executor thread and is not awaited."""
        if seq_id not in self._queues:
            return
        self._queues.pop(seq_id, None)
        try:
            f = self._lock_pool.submit(self.engine.abort, seq_id)
        except RuntimeError:
            self.engine.abort(seq_id)
        else:
            f.add_done_callback(
                lambda f: f.exception() and logger.warning(
                    "async abort of %s failed: %s", seq_id,
                    f.exception()))

    async def stream(self, prompt_tokens: List[int],
                     options: SamplingOptions,
                     model: Optional[str] = None,
                     deadline: Optional[float] = None
                     ) -> AsyncIterator[StepOutput]:
        seq_id, q = await self.submit(prompt_tokens, options, model=model,
                                      deadline=deadline)
        try:
            while True:
                out = await q.get()
                if isinstance(out, BaseException):
                    raise out
                yield out
                if out.finished:
                    return
        finally:
            # client gone mid-stream (no-op after a terminal output)
            self.abort(seq_id)

    @property
    def tokenizer(self):
        return self.engine.tokenizer
