"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` exposes a plain C interface (pointers and
the stream as ``void*``, sizes as ``int``) and compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repo root, on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \\
         csrc/<name>.cu

The hash covers the source and the flags, so an edited source rebuilds and
an unchanged one loads the library already built.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for all of them.  ``ptxas``'s
register and shared-memory report is kept beside each library
(``<name>-<hash>.log``) and returned in :class:`BuildInfo`.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "SOURCES", "BuildInfo", "build", "load", "nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant_matmul", "crossbar_exec", "pim_bits")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    name: str
    path: Path
    seconds: float      # nvcc wall time (0.0 when the library was cached)
    cached: bool
    log: str            # nvcc / ptxas output

    @property
    def ptxas_lines(self) -> List[str]:
        """``ptxas`` lines on registers, shared memory and spills."""
        return [ln.strip() for ln in self.log.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln]


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_info: Dict[str, BuildInfo] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or CUDACXX); the "
                       "CUDA kernels are built from source on first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, BuildInfo]:
    """Build (or find already built) the named sources, one ``nvcc`` per
    source, all started together.  Raises if any build fails."""
    names = names or SOURCES
    with _lock:
        todo = [n for n in names if n not in _info]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            if out.exists():
                log = out.with_suffix(".log")
                _info[n] = BuildInfo(n, out, 0.0, True,
                                     log.read_text() if log.exists() else "")
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu (exit "
                              f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
            _info[n] = BuildInfo(n, out, time.perf_counter() - t0, False, log)
        if failed:
            raise RuntimeError("\n".join(failed))
        return {n: _info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        info = build(name)[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(info.path))
                _libs[name] = lib
    return lib
