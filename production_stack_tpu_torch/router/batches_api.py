"""OpenAI Batch API: JSONL batches executed against the routed engines.

Capability parity with reference src/vllm_router/services/batch_service/
(SQLite-backed queue, local_processor.py:24-210) and routers/
batches_router.py (POST/GET/list/cancel). The reference's processor is a
broken placeholder (imports a nonexistent package and sleeps instead of
running requests — SURVEY.md §2.1 batch row); this one actually executes:
each JSONL line is routed through the live routing policy to a backend,
responses are written to an output file in OpenAI batch-output format.

SQLite is used synchronously — batch bookkeeping writes are tiny and
rare relative to inference; the event loop impact is microseconds.
"""

import asyncio
import json
import sqlite3
import time
import uuid
from typing import Optional

import aiohttp
from aiohttp import web

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS batches (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    input_file_id TEXT NOT NULL,
    endpoint TEXT NOT NULL,
    completion_window TEXT,
    created_at INTEGER,
    completed_at INTEGER,
    output_file_id TEXT,
    error_file_id TEXT,
    counts TEXT DEFAULT '{}'
)
"""


class BatchStore:
    def __init__(self, path: str):
        self.db = sqlite3.connect(path)
        self.db.row_factory = sqlite3.Row
        self.db.execute(_SCHEMA)
        # batches orphaned in_progress by a crash/restart are re-queued
        # (idempotent: line results are regenerated from the input file)
        self.db.execute(
            "UPDATE batches SET status='validating' "
            "WHERE status='in_progress'")
        self.db.commit()

    def create(self, input_file_id: str, endpoint: str,
               completion_window: str) -> dict:
        batch_id = f"batch-{uuid.uuid4().hex[:24]}"
        self.db.execute(
            "INSERT INTO batches (id, status, input_file_id, endpoint, "
            "completion_window, created_at) VALUES (?,?,?,?,?,?)",
            (batch_id, "validating", input_file_id, endpoint,
             completion_window, int(time.time())))
        self.db.commit()
        return self.get(batch_id)

    def get(self, batch_id: str) -> Optional[dict]:
        row = self.db.execute("SELECT * FROM batches WHERE id=?",
                              (batch_id,)).fetchone()
        return self._to_obj(row) if row else None

    def list(self) -> list:
        rows = self.db.execute(
            "SELECT * FROM batches ORDER BY created_at DESC").fetchall()
        return [self._to_obj(r) for r in rows]

    def update(self, batch_id: str, **fields) -> None:
        sets = ", ".join(f"{k}=?" for k in fields)
        self.db.execute(f"UPDATE batches SET {sets} WHERE id=?",
                        (*fields.values(), batch_id))
        self.db.commit()

    def next_pending(self) -> Optional[dict]:
        row = self.db.execute(
            "SELECT * FROM batches WHERE status='validating' "
            "ORDER BY created_at LIMIT 1").fetchone()
        return self._to_obj(row) if row else None

    @staticmethod
    def _to_obj(row: sqlite3.Row) -> dict:
        counts = json.loads(row["counts"] or "{}")
        return {
            "id": row["id"], "object": "batch", "status": row["status"],
            "input_file_id": row["input_file_id"],
            "endpoint": row["endpoint"],
            "completion_window": row["completion_window"],
            "created_at": row["created_at"],
            "completed_at": row["completed_at"],
            "output_file_id": row["output_file_id"],
            "error_file_id": row["error_file_id"],
            "request_counts": counts,
        }


class BatchProcessor:
    """Polls for pending batches and executes them line by line."""

    def __init__(self, state: dict, store: BatchStore,
                 poll_interval: float = 1.0):
        self.state = state
        self.store = store
        self.poll_interval = poll_interval
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="batch-proc")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            batch = self.store.next_pending()
            if batch is None:
                await asyncio.sleep(self.poll_interval)
                continue
            try:
                await self._run_batch(batch)
            except Exception:
                logger.exception("batch %s failed", batch["id"])
                self.store.update(batch["id"], status="failed")

    async def _run_batch(self, batch: dict) -> None:
        storage = self.state["file_storage"]
        content = await storage.get_content(batch["input_file_id"])
        if content is None:
            self.store.update(batch["id"], status="failed")
            return
        self.store.update(batch["id"], status="in_progress")
        results, errors = [], []
        completed = failed = 0
        for line in content.decode().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                result = await self._run_one(batch, req)
                results.append(json.dumps(result))
                if result["response"]["status_code"] == 200:
                    completed += 1
                else:
                    failed += 1
            except Exception as e:
                failed += 1
                errors.append(json.dumps({
                    "custom_id": None, "error": str(e)}))
            # allow cancellation between lines
            current = self.store.get(batch["id"])
            if current and current["status"] == "cancelled":
                return
        out = await storage.save(f"{batch['id']}-output.jsonl",
                                 ("\n".join(results) + "\n").encode(),
                                 purpose="batch_output")
        err_id = None
        if errors:
            err = await storage.save(f"{batch['id']}-errors.jsonl",
                                     ("\n".join(errors) + "\n").encode(),
                                     purpose="batch_output")
            err_id = err.id
        self.store.update(
            batch["id"], status="completed", completed_at=int(time.time()),
            output_file_id=out.id, error_file_id=err_id,
            counts=json.dumps({"total": completed + failed,
                               "completed": completed, "failed": failed}))
        logger.info("batch %s done: %d ok, %d failed", batch["id"],
                    completed, failed)

    async def _run_one(self, batch: dict, req: dict) -> dict:
        """Route one batch line through the live routing policy."""
        body = req.get("body", {})
        model = body.get("model", "")
        endpoints = [ep for ep in self.state["discovery"].get_endpoints()
                     if ep.serves(model)]
        if not endpoints:
            return {"id": f"batch_req_{uuid.uuid4().hex[:16]}",
                    "custom_id": req.get("custom_id"),
                    "response": {"status_code": 400, "body": {
                        "error": f"no backend serves {model!r}"}}}
        health = self.state.get("health")
        if health is not None:
            endpoints = health.healthy_endpoints(endpoints)
        url = self.state["router"].route(
            endpoints, self.state["request_stats"].snapshot(), {}, body)
        path = req.get("url", batch["endpoint"])
        session: aiohttp.ClientSession = self.state["client"]
        from production_stack_tpu_torch.router.service_discovery import (
            engine_auth_headers)
        async with session.post(f"{url}{path}", json=body,
                                headers=engine_auth_headers()) as resp:
            try:
                payload = await resp.json()
            except (aiohttp.ContentTypeError, json.JSONDecodeError):
                payload = {"error": await resp.text()}
            return {"id": f"batch_req_{uuid.uuid4().hex[:16]}",
                    "custom_id": req.get("custom_id"),
                    "response": {"status_code": resp.status,
                                 "body": payload}}


# ---------------------------------------------------------------- handlers

def mount_batches_api(app: web.Application, db_path: str) -> None:
    store = BatchStore(db_path)
    state = app["state"]
    state["batch_store"] = store
    processor = BatchProcessor(state, store)
    state["batch_processor"] = processor

    async def create(request: web.Request) -> web.Response:
        body = await request.json()
        for field in ("input_file_id", "endpoint"):
            if field not in body:
                return web.json_response(
                    {"error": {"message": f"missing {field!r}"}}, status=400)
        if await state["file_storage"].get(body["input_file_id"]) is None:
            return web.json_response(
                {"error": {"message": "input file not found"}}, status=404)
        batch = store.create(body["input_file_id"], body["endpoint"],
                             body.get("completion_window", "24h"))
        return web.json_response(batch)

    async def retrieve(request: web.Request) -> web.Response:
        batch = store.get(request.match_info["batch_id"])
        if batch is None:
            return web.json_response(
                {"error": {"message": "batch not found"}}, status=404)
        return web.json_response(batch)

    async def list_batches(request: web.Request) -> web.Response:
        return web.json_response({"object": "list", "data": store.list()})

    async def cancel(request: web.Request) -> web.Response:
        batch = store.get(request.match_info["batch_id"])
        if batch is None:
            return web.json_response(
                {"error": {"message": "batch not found"}}, status=404)
        if batch["status"] in ("validating", "in_progress"):
            store.update(batch["id"], status="cancelled")
            batch = store.get(batch["id"])
        return web.json_response(batch)

    app.router.add_post("/v1/batches", create)
    app.router.add_get("/v1/batches", list_batches)
    app.router.add_get("/v1/batches/{batch_id}", retrieve)
    app.router.add_post("/v1/batches/{batch_id}/cancel", cancel)
    app.router.add_delete("/v1/batches/{batch_id}", cancel)

    async def start_proc(app):
        await processor.start()

    async def stop_proc(app):
        await processor.close()

    app.on_startup.append(start_proc)
    app.on_cleanup.append(stop_proc)
