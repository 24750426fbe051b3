"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``: no PyTorch headers, so a
build takes seconds. Builds happen at first use, on the machine with the
card, into ``kernels/build/`` (ignored by git). A library's file name
carries a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused. ``build`` starts one ``nvcc`` per source, all
at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: sm_90a: Hopper's full feature set. --fmad=false: no multiply-add
#: contraction anywhere, so kernel arithmetic rounds like the plain
#: PyTorch versions, operation by operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

#: Kernel sources by name.
SOURCES = ("wire_digest", "wire_codec", "join_extract", "polyline_min_dist")

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and spill report) per kernel built in
#: this process.
build_logs: Dict[str, str] = {}
#: Scratch buffers that a kernel leaves as it found them, by (kernel,
#: device index, stream, size): see ``scratch``.
_scratch: Dict[tuple, Any] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Raises with nvcc's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        path = _lib_path(name)
        out[name] = path
        if path.is_file():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[name])  # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib


def scratch(key: tuple, make: Callable[[], Any]) -> Any:
    """The scratch buffer for ``key``, made by ``make()`` at its first use.

    For a kernel that resets its scratch before it returns, so the buffer
    is filled once and never again. The key names the stream: calls on
    one stream run in order, calls on two streams could overlap and must
    not share a buffer."""
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = make()
    return buf


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
