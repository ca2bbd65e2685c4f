"""Build the port's CUDA kernels with nvcc on first use, and its host
library (the pattern compressor) with the host compiler.

Each ``csrc/*.cu`` source becomes a shared library with a plain C
interface (loaded with ctypes), compiled for ``sm_90a`` into
``bpp_tpu_torch/_build/<name>-<hash>.so``, with nvcc's report (``-Xptxas
-v``: each kernel's registers and spills) beside it in
``<name>-<hash>.log``.  The hash covers the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads from the cache.  A failed build
raises with nvcc's stderr.  :func:`build_host` does the same for a
``csrc/*.cpp`` source with ``g++`` (``HOST_FLAGS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
# -split-compile 0: each source instantiates its kernel for 2 scalar types
# (float, double) x 3 model families x 8 category counts x 2 CLV stores;
# nvcc optimises them on all the host's cores
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile", "0", "-shared", "-Xcompiler", "-fPIC")

# the kernel sources: K1 (pack), K2 (fels), K3/K4 (the accept chains), K5
# (the sim-SPR walk)
KERNELS = ("pack_kernel", "fels_kernel", "chain_kernel", "simwalk_kernel")

# the flags of bpp_tpu's native/Makefile
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:16]}.so"


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing,
    one nvcc process per source, all started together."""
    outs = [library_path(name) for name in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        # the -Xptxas -v report: registers and spills of every kernel
        out.with_suffix(".log").write_text(stderr)
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build_host(name: str, timeout: float = 120.0) -> Path:
    """Compile ``csrc/<name>.cpp`` with ``g++`` into
    ``_build/<name>-<hash>.so`` unless it exists; the hash covers the
    source and ``HOST_FLAGS``.  Raises when the compiler is missing or
    fails."""
    src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()
    out = BUILD / f"{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *HOST_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {name}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
