"""Finding a cell's files by the names in ``BENCHMARK.json``.

Under the harness's folder (``h100_bench/`` of the checkout):
- ``configs/<config>.json``: a model configuration, the file named by
  the ``configs`` entry;
- ``traffic/<traffic>.json``: a traffic mix (traffic.py reads it);
- ``cells/<workload>.json``: the cell's engine geometry (``engine``,
  EngineConfig fields), its offered ``rate`` (requests a second) and
  its check of what was served (``correct``);
- ``metrics/<metric>.py``: each metric's reader, a module with
  ``read(ctx)`` returning the metric's value, or None where the run
  holds nothing for it to read.

So a configuration, a cell or a metric is added by files and entries,
never by an edit of a file that is there.
"""

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HARNESS = "h100_bench"


class Bench:
    def __init__(self, root):
        self.root = Path(root).resolve()
        self.dir = self.root / HARNESS
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self._readers: Dict[str, object] = {}

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there "
                       f"are {[w['name'] for w in self.spec['workloads']]}")

    def config_entry(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> Path:
        return self.root / self.config_entry(name)["file"]

    def config(self, name: str) -> Dict:
        with open(self.config_path(name)) as f:
            return json.load(f)

    def traffic(self, name: str) -> Dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name: str) -> Dict:
        with open(self.dir / "cells" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The metrics a run of the cell reports: its end-to-end ones
        untraced, its per-layer ones traced. A metric without a
        ``workloads`` list is every cell's that reports the end-to-end
        metric it moves."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``."""
        mod = self._readers.get(metric)
        if mod is None:
            path = self.dir / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                f"{HARNESS}_metric_{len(self._readers)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod
        return mod

    def read(self, metric: Dict, ctx) -> Optional[float]:
        return self.reader(metric["name"]).read(ctx)
