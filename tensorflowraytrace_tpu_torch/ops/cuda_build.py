"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library in ``build/`` at the repository
root, under a name keyed by a hash of the source, the headers it includes
from ``csrc/`` and the flags, so a changed source or header gets a new
library.  ``build`` starts one ``nvcc`` for each missing
library, all together, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # bit-for-bit agreement of the triangle search with its plain version;
    # see the note in csrc/triangle_search.cu
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIBS = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _local_headers(src: Path) -> list:
    """The ``csrc/`` headers ``src`` includes with ``#include "..."``, and
    theirs, each once."""
    found = []
    todo = [src]
    while todo:
        text = todo.pop().read_text()
        for name in re.findall(r'^#include "([^"]+)"', text, re.MULTILINE):
            header = CSRC_DIR / name
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(source: str) -> Path:
    """The library ``csrc/<source>`` builds into: its name hashes the
    source, the headers it includes from ``csrc/`` and the flags."""
    src = CSRC_DIR / source
    text = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in _local_headers(src))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build(sources, verbose: bool = False) -> dict:
    """Compile every source of ``sources`` whose library does not exist yet,
    one ``nvcc`` each, all started together.  ``verbose`` adds ``-Xptxas -v``.
    Returns ``{source: compiler output}`` for what was compiled; raises after
    every compiler has ended if any failed."""
    jobs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((source, out, tmp, cmd, proc))
    reports, failures = {}, []
    for source, out, tmp, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        reports[source] = stdout + stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if missing."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
    return lib
