"""Build and load the port's CUDA C++ kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under ``_build/`` (git-ignored);
``ctypes`` loads it. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a current one is reused. Callers
bind each entry point with explicit ``argtypes``; every entry point returns
``cudaGetLastError()`` after its launch.

:func:`build_host` does the same for the host library ``csrc/nndet_host.cpp``
(the greedy NMS, WBC and COCO matching loops on the CPU) with the host C++
compiler, no ``nvcc``.
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


HOST_SOURCE = CSRC / "nndet_host.cpp"
# no -march=native: one build serves any x86-64 host. No contraction: GCC's
# default -ffp-contract=fast may fuse vol(a) + vol(b) - inter into an FMA, and
# the float64 IoU would then round otherwise than NumPy's box_iou_np
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")


def host_compiler() -> Optional[str]:
    """``$CXX``, else ``g++`` or ``c++`` on ``PATH``; ``None`` if none is
    found."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def host_library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return Path(build_dir) / f"libnndet_torch_host_{h.hexdigest()[:16]}.so"


def build_host(build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """Compile ``csrc/nndet_host.cpp`` unless a library of the current source
    exists; ``None`` when no C++ compiler is found. A failed compile raises."""
    out = host_library_path(build_dir)
    if out.exists():
        return out
    cxx = host_compiler()
    if cxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile in a private directory and rename: concurrent builds never load
    # a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = Path(tmp) / out.name
        cmd = [cxx, *HOST_CXX_FLAGS, str(HOST_SOURCE), "-o", str(lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host library build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


_host_lib: Optional[ctypes.CDLL] = None


def load_host() -> Optional[ctypes.CDLL]:
    """Build if needed and load the host library (once per process); ``None``
    when no C++ compiler is found. A failed compile or ``dlopen`` raises."""
    global _host_lib
    if _host_lib is None:
        path = build_host()
        if path is not None:
            _host_lib = ctypes.CDLL(str(path))
    return _host_lib


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
