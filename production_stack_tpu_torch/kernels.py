"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. The sources
share the attention tile of ``csrc/attention_tile.cuh``. Libraries go
to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a digest of the source, the shared headers and
the flags, so an edited source or header is rebuilt and an unchanged one
is reused. Nothing is built when
this module is imported: the first call that needs a kernel builds it.
``ptxas`` reports every kernel's registers, shared memory and spills in
the build log (``resource_report`` reads it), and ``sass_count`` counts
an instruction in a built library (e.g. ``HGMMA``, the wgmma of sm_90a).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("paged_attention", "flash_attention")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump, cu++filt) from
    $CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", name)):
            return os.path.join(cand, "bin", name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: the CUDA kernels are built "
                           f"from csrc/ on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of one source goes: named by a digest of the
    source, the headers of ``csrc/`` it may include, and the flags."""
    h = hashlib.sha1(SOURCES[name].read_bytes())
    for header in sorted(SOURCES[name].parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (all by default) that are not built
    yet, one nvcc process per source, all started together. Returns
    {name: {"seconds": wall, "log": compiler output}}; raises on the
    first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in (names or SOURCES):
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
    return report


def build_log(name: str) -> str:
    """The compiler output of the built library of one source (kept
    beside it, for ``resource_report``); empty if none was kept."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def _demangle(names):
    """Readable kernel names (cu++filt), the mangled ones where the
    toolkit has no demangler."""
    try:
        out = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def resource_report(log: str) -> Dict[str, dict]:
    """{kernel: {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}} for every entry function in an nvcc log built with
    ``-Xptxas -v`` (static shared memory only; the kernels take theirs
    dynamically, sized at launch)."""
    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = kernels.get(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return dict(zip(_demangle(list(kernels)), kernels.values()))


def sass_count(name: str, opcode: str) -> Dict[str, int]:
    """{kernel: count of `opcode` in its SASS} over the built library of
    one source (cuobjdump -sass)."""
    out = subprocess.run([cuda_tool("cuobjdump"), "-sass",
                          str(library_path(name))], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(rf"\b{opcode}\b", line):
            counts[cur] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))
