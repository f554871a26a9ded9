"""Build a CUDA source of ``tinyedm_tpu_torch/csrc`` into a shared library
with a plain C interface, and load it with ctypes.

Nothing is built at import: the first call of ``load_library(name)`` runs
``nvcc`` for ``sm_90a`` into ``tinyedm_tpu_torch/build/`` (listed in
``.gitignore``). The library's file name carries a hash of its source, of
the headers beside it and of the flags, so an edited source is rebuilt and a
stale library is never loaded. A source that needs a library of the toolkit
names it in ``LINK``; it is linked with an rpath to the toolkit's library
directory, so that ctypes finds it without ``LD_LIBRARY_PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# source name -> the toolkit libraries it links
LINK = {"nvjpeg_decode": ["nvjpeg"]}

_loaded: dict[str, ctypes.CDLL] = {}
# name -> what ptxas printed for the library's kernels, from build(...,
# ptxas_verbose=True)
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (neither on PATH nor under $CUDA_HOME/bin)")


def _link_flags(name: str) -> list[str]:
    if name not in LINK:
        return []
    lib_dir = Path(_nvcc()).resolve().parent.parent / "lib64"
    return [f"-l{lib}" for lib in LINK[name]] + ["-Xlinker", f"-rpath={lib_dir}"]


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    flags = NVCC_FLAGS + _link_flags(name)
    blob = b"".join(p.read_bytes() for p in sources) + " ".join(flags).encode()
    digest = hashlib.sha256(blob).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, ptxas_verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; returns
    the library path. ``ptxas_verbose`` keeps ptxas's report of registers,
    shared memory and spills of each kernel in ``ptxas_log[name]``; a failed
    build prints the compiler's output either way."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu"), *_link_flags(name)]
    try:
        done = subprocess.run(cmd, capture_output=ptxas_verbose, text=True)
        if done.returncode:
            if ptxas_verbose:
                print(done.stdout + done.stderr, file=sys.stderr)
            raise RuntimeError(f"nvcc failed ({done.returncode}) on csrc/{name}.cu")
        if ptxas_verbose:
            ptxas_log[name] = done.stdout + done.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def ptxas_registers(log: str) -> dict[str, int]:
    """The registers a thread of each kernel entry in a ptxas ``-v``
    report (``ptxas_log[name]``), by mangled entry name."""
    regs, entry = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            regs[entry] = int(m.group(1))
    return regs


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        # csrc/common.cuh: every library exports it
        lib.tinyedm_error_string.argtypes = [ctypes.c_int]
        lib.tinyedm_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def raise_on_error(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch function of ``lib`` returned a CUDA error."""
    if err:
        msg = lib.tinyedm_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
