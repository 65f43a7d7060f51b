"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC --split-compile=0`` into its own shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds (``--split-compile=0`` runs the device optimiser over
a source's kernels on every core: ``ovsf_gemm.cu``'s 50 instantiations
took 87.5 s alone and 37.3 s so on an H100 host's 8 cores). Libraries
land in ``kernels/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, of the shared headers (``csrc/*.cuh``) and
of the flags, so an edited source, header or flag is never served by a
stale library. Nothing is built when the module is imported: ``load``
builds at first use, ``build_all`` builds every source at once with one
``nvcc`` per source running in parallel, and ``launcher`` returns a
source's typed C launch function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("ovsf_gemm", "ovsf_decompress", "paged_decode_attn", "fwht",
           "flash_decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are compiled on the machine with the card")
    return path


def lib_path(name: str) -> Path:
    """The library of one source, named by a hash of the source, every
    shared header in ``csrc`` (a source may include any of them) and the
    flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def _nvcc_cmd(name: str, out: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: path}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def launcher(name: str, argtypes, kernel: str = ""):
    """The C function ``<kernel>_launch`` (``kernel`` defaults to the
    source's name) of one source, typed at first use; it returns the
    launch's ``cudaError_t``."""
    fn = getattr(load(name), f"{kernel or name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
