"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions and is compiled on its own
by `nvcc` for Hopper (`sm_90a`) into `build/<name>-<hash>.so` inside the
package (the directory is git-ignored). The hash covers the source and the
flags, so an edited source builds anew. Nothing is built at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o build/<name>-<hash>.so
         csrc/<name>.cu

`-fmad=false` keeps nvcc from contracting a product and a sum into one FMA:
the kernels hold bit-exactness with the plain versions, which round each
operation. No `--use_fast_math`. `-Xptxas -v` makes ptxas report each
kernel's registers, shared memory and spills; `LOGS` keeps that output
for every source this process built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}  # nvcc's output by source name, as built here


def nvcc_path() -> str:
    """`nvcc` from CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start_nvcc(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names) -> None:
    """Compile the named sources that have no current library, one `nvcc`
    per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {n: _start_nvcc(n, library_path(n)) for n in names
            if not library_path(n).is_file()}
    for name, (proc, tmp) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, library_path(name))
        LOGS[name] = log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
