"""Build and load the port's CUDA C++ kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under ``_build/`` (git-ignored);
``ctypes`` loads it. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a current one is reused. Callers
bind each entry point with explicit ``argtypes``; every entry point returns
``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no fused multiply-add contraction: the NMS IoU must round exactly as
    # the plain PyTorch version does, so that selected indices are identical
    "-fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

# the compiler's output of the last build (registers, shared memory and
# spills per kernel, from -Xptxas -v)
BUILD_LOG = BUILD_DIR / "build.log"

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnndet_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile and link in a private directory and rename the library:
    # concurrent builds never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        procs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(Path(tmp) / f"{src.stem}.o")]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in procs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *(c[-1] for c, _ in procs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}): {' '.join(cmd)}\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, out)
    BUILD_LOG.write_text("".join(logs))
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


@functools.lru_cache(maxsize=None)
def constants(source: str) -> Dict[str, int]:
    """The integer literals a kernel source, or a header of ``csrc`` it
    includes, declares as ``constexpr int kName = value;``: the geometry
    that the Python launch plans read, so that it is stated once, in the
    kernel's source. Reads the files; needs no ``nvcc``."""
    text = (CSRC / source).read_text()
    out: Dict[str, int] = {}
    for header in re.findall(r'#include\s+"([^"]+)"', text):
        out.update(constants(header))
    out.update({m.group(1): int(m.group(2))
                for m in re.finditer(r"constexpr\s+int\s+(k\w+)\s*=\s*(\d+)\s*;", text)})
    return out


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
