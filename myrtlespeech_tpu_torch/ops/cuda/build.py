"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``myrtlespeech_tpu_torch/csrc/<name>.cu`` is compiled on its own into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

A source may include the shared headers beside it (``csrc/*.cuh``).  The
library lands in ``build/kernels/`` at the root of the checkout, named by a
hash of its source, the headers and the flags, so an edited source or header
builds again and an unchanged one is reused.  Builds run at first use;
:func:`build` starts one ``nvcc`` per source, all at once.  A missing
``nvcc`` or a failed build raises: nothing falls back to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the CUDA toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(f"nvcc not found on PATH or at {DEFAULT_NVCC}: "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    the headers beside it (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named sources (all by default) that are not built yet.

    Returns the seconds each build took (0.0 for one already built).  The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>-<hash>.log``.
    """
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    running = {}
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[n] = (proc, tmp, out, time.perf_counter())
    failed = []
    for n, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
