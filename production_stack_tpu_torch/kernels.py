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
"""

import ctypes
import hashlib
import os
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
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
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
