"""OpenAI Files API: upload/retrieve/list/delete with local-disk storage.

Capability parity with reference src/vllm_router/services/files_service/
(Storage ABC + FileStorage under /tmp/vllm_files, storage.py:7-157) and
routers/files_router.py (POST /v1/files multipart, GET /v1/files/{id},
GET /v1/files/{id}/content). Re-designed: one Storage class with JSON
metadata sidecars, fully async via aiofiles.
"""

import json
import os
import time
import uuid
from dataclasses import asdict, dataclass
from typing import List, Optional

import aiofiles
import aiofiles.os
from aiohttp import web


@dataclass
class FileObject:
    id: str
    bytes: int
    created_at: int
    filename: str
    purpose: str = "batch"
    object: str = "file"


class FileStorage:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _data_path(self, file_id: str) -> str:
        return os.path.join(self.root, file_id)

    def _meta_path(self, file_id: str) -> str:
        return os.path.join(self.root, file_id + ".json")

    async def save(self, filename: str, content: bytes,
                   purpose: str = "batch") -> FileObject:
        file_id = f"file-{uuid.uuid4().hex[:24]}"
        info = FileObject(id=file_id, bytes=len(content),
                          created_at=int(time.time()), filename=filename,
                          purpose=purpose)
        async with aiofiles.open(self._data_path(file_id), "wb") as f:
            await f.write(content)
        async with aiofiles.open(self._meta_path(file_id), "w") as f:
            await f.write(json.dumps(asdict(info)))
        return info

    async def get(self, file_id: str) -> Optional[FileObject]:
        try:
            async with aiofiles.open(self._meta_path(file_id)) as f:
                return FileObject(**json.loads(await f.read()))
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    async def get_content(self, file_id: str) -> Optional[bytes]:
        try:
            async with aiofiles.open(self._data_path(file_id), "rb") as f:
                return await f.read()
        except FileNotFoundError:
            return None

    async def list(self) -> List[FileObject]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".json"):
                info = await self.get(name[:-5])
                if info:
                    out.append(info)
        return out

    async def delete(self, file_id: str) -> bool:
        found = False
        for path in (self._data_path(file_id), self._meta_path(file_id)):
            try:
                await aiofiles.os.remove(path)
                found = True
            except FileNotFoundError:
                pass
        return found


# ---------------------------------------------------------------- handlers

def mount_files_api(app: web.Application, storage_path: str) -> None:
    storage = FileStorage(storage_path)
    app["state"]["file_storage"] = storage

    async def upload(request: web.Request) -> web.Response:
        reader = await request.multipart()
        purpose, filename, content = "batch", "upload", None
        async for part in reader:
            if part.name == "purpose":
                purpose = (await part.read()).decode()
            elif part.name == "file":
                filename = part.filename or filename
                content = await part.read()
        if content is None:
            return web.json_response(
                {"error": {"message": "missing 'file' part"}}, status=400)
        info = await storage.save(filename, content, purpose)
        return web.json_response(asdict(info))

    async def retrieve(request: web.Request) -> web.Response:
        info = await storage.get(request.match_info["file_id"])
        if info is None:
            return web.json_response(
                {"error": {"message": "file not found"}}, status=404)
        return web.json_response(asdict(info))

    async def content(request: web.Request) -> web.Response:
        data = await storage.get_content(request.match_info["file_id"])
        if data is None:
            return web.json_response(
                {"error": {"message": "file not found"}}, status=404)
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def list_files(request: web.Request) -> web.Response:
        files = await storage.list()
        return web.json_response(
            {"object": "list", "data": [asdict(f) for f in files]})

    async def delete(request: web.Request) -> web.Response:
        ok = await storage.delete(request.match_info["file_id"])
        return web.json_response(
            {"id": request.match_info["file_id"], "object": "file",
             "deleted": ok}, status=200 if ok else 404)

    app.router.add_post("/v1/files", upload)
    app.router.add_get("/v1/files", list_files)
    app.router.add_get("/v1/files/{file_id}", retrieve)
    app.router.add_get("/v1/files/{file_id}/content", content)
    app.router.add_delete("/v1/files/{file_id}", delete)
