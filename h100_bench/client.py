"""The load generator: a process of its own, so that its host work does
not share the engine's interpreter.

    python -m h100_bench.client PLAN.json OUT.json

PLAN.json (written by run.py): ``url``, ``model``, ``warm_s``,
``seconds``, ``drain_s``, ``deadline`` (a
``time.monotonic()`` past which no load is offered) and the
``requests`` of traffic.plan. Every request is a streamed ``POST
/v1/completions`` of token ids at temperature 0 with ``ignore_eos`` and
``max_tokens`` the drawn output length; ``logprobs: 0`` makes every
token its own SSE event, which carries the token's text.

The window: the open loop starts its schedule at once and opens the
window ``warm_s`` later. The window lasts ``seconds``. After it closes the load goes on, so the window's
last requests finish under the same load, until every request of the
window has finished or ``drain_s`` has passed; then every stream is
closed. The process prints ``open <t>`` and ``close <t>`` on standard
output as they happen (``time.monotonic()``, which every process of the
machine shares) and writes OUT.json last: the window's times, the
generator's lateness and one record per request sent.
"""

import asyncio
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

import aiohttp
import numpy as np


def prompt_key(ids) -> str:
    """The key under which the server side files a prompt's tokens."""
    return hashlib.sha1(np.asarray(ids, np.int32).tobytes()).hexdigest()


class Generator:
    def __init__(self, plan: Dict):
        self.plan = plan
        self.records: List[Dict] = []
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None

    def _say(self, what: str, t: float) -> None:
        sys.stdout.write(f"{what} {t!r}\n")
        sys.stdout.flush()

    def _open(self, t: float) -> None:
        if self.t_open is None:
            self.t_open = t
            self.t_close = t + self.plan["seconds"]
            self._say("open", t)
            asyncio.get_running_loop().call_at(
                self.t_close, self._say, "close", self.t_close)

    def in_window(self, t: float) -> bool:
        return (self.t_open is not None and self.t_open <= t < self.t_close)

    def window_pending(self) -> bool:
        return any(r["in_window"] and not r["ended"] for r in self.records)

    def keep_going(self) -> bool:
        """Load is offered until the window's requests have ended."""
        now = time.monotonic()
        if now > self.plan["deadline"]:
            return False
        if self.t_close is None or now < self.t_close:
            return True
        return (self.window_pending()
                and now < self.t_close + self.plan["drain_s"])

    def new_record(self, i: int, due: float) -> Dict:
        req = self.plan["requests"][i]
        rec = {"i": i, "due": due, "sent": time.monotonic(),
               "max_tokens": req["max_tokens"],
               "prompt_len": len(req["prompt"]),
               "key": prompt_key(req["prompt"]), "times": [],
               "tokens": [], "finished": False, "ended": False,
               "error": None, "in_window": self.in_window(due)}
        self.records.append(rec)
        return rec

    async def request(self, session: aiohttp.ClientSession,
                      rec: Dict) -> None:
        req = self.plan["requests"][rec["i"]]
        body = {"model": self.plan["model"], "prompt": req["prompt"],
                "max_tokens": req["max_tokens"], "temperature": 0.0,
                "ignore_eos": True, "stream": True, "logprobs": 0}
        try:
            async with session.post(self.plan["url"] + "/v1/completions",
                                    json=body) as resp:
                if resp.status != 200:
                    rec["error"] = (f"http {resp.status}: "
                                    f"{(await resp.text())[:200]}")
                    return
                async for line in resp.content:
                    if not line.startswith(b"data: "):
                        continue
                    data = line[6:].strip()
                    if data == b"[DONE]":
                        break
                    now = time.monotonic()
                    obj = json.loads(data)
                    for ch in obj.get("choices") or ():
                        lp = ch.get("logprobs") or {}
                        for tok in lp.get("tokens") or ():
                            rec["times"].append(now)
                            rec["tokens"].append(tok)
                        if ch.get("finish_reason"):
                            rec["finished"] = True
            if not rec["finished"]:
                rec["error"] = "stream ended without a finish"
        except (aiohttp.ClientError, asyncio.TimeoutError,
                ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            rec["ended"] = True

    async def run_open(self, session) -> None:
        t0 = time.monotonic()
        t_open = t0 + self.plan["warm_s"]
        opener = asyncio.get_running_loop().call_at(
            t_open, self._open, t_open)
        tasks = []
        for i, req in enumerate(self.plan["requests"]):
            due = t0 + req["due"]
            delay = due - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if not self.keep_going():
                break
            if self.t_open is None and due >= t_open:
                self._open(t_open)
            tasks.append(asyncio.ensure_future(
                self.request(session, self.new_record(i, due))))
        opener.cancel()
        await self._finish(tasks)

    async def _finish(self, tasks) -> None:
        """Wait until the window's requests have ended (or the drain
        has passed), then close every stream still open."""
        while self.keep_going():
            await asyncio.sleep(0.05)
            if all(t.done() for t in tasks):
                break
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    async def main(self) -> Dict:
        conn = aiohttp.TCPConnector(limit=0)
        timeout = aiohttp.ClientTimeout(total=None, sock_read=None)
        async with aiohttp.ClientSession(connector=conn,
                                         timeout=timeout) as session:
            await self.run_open(session)
        end = time.monotonic()
        for r in self.records:
            r["ended"] = True
        late = [r["sent"] - r["due"] for r in self.records
                if r["in_window"]]
        return {"open": self.t_open, "close": self.t_close, "end": end,
                "lateness_s": late, "records": self.records}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        plan = json.load(f)
    out = asyncio.run(Generator(plan).main())
    tmp = argv[1] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
