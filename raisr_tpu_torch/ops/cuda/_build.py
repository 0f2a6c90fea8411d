"""Build the package's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles every `raisr_tpu_torch/csrc/*.cu` for Hopper (sm_90a), one
process a source, all started together, and links the objects into one
shared library with a plain C interface, `build/torch_kernels/libraisr_kernels.so`
at the root of the checkout. No PyTorch headers are included, so a build takes
seconds. The library is rebuilt when the hash of the sources, the headers they
share (`csrc/*.cuh`) and the flags changes.
`--fmad=false` keeps every multiply and add rounded on its own, as the plain
PyTorch versions round them.

Nothing here runs at import time, and there is no fallback: a missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parents[2]
SOURCES_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libraisr_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "raisr_tpu_torch CUDA kernels cannot be built."
    )


def _sources() -> list[pathlib.Path]:
    srcs = sorted(SOURCES_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SOURCES_DIR}")
    return srcs


def _digest(srcs: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(SOURCES_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources unless the library on disk matches their hash.

    Returns the library's path. `verbose` adds `-Xptxas -v` and prints what
    nvcc reports (registers, shared memory, spills)."""
    srcs = _sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build into a temporary directory, then rename the library: a
    # concurrent loader never sees a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c",
                 "-o", os.path.join(tmp, src.stem + ".o"), str(src)] for src in srcs]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, LIB_NAME),
                *(cmd[-2] for cmd in cmds)]
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            if verbose:
                print(out, end="")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(os.path.join(tmp, LIB_NAME), lib)
    stamp.write_text(digest)
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every launcher's C signature."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raisr_full_hash_filter
    fn.argtypes = [vp, vp, i, vp, f, vp, vp, i, i, i, vp, f, vp, i, vp, i, i, i, i, f, i, vp]
    fn.restype = i
    fn = lib.raisr_gather_buckets
    fn.argtypes = [vp, vp, vp, i, vp, f, vp, i, i, i, i, i, i, i, vp]
    fn.restype = i
    fn = lib.raisr_hash_buckets
    fn.argtypes = [vp, vp, i, i, vp, f, vp, i, vp, i, i, i, i, f, i, vp]
    fn.restype = i
    fn = lib.raisr_full_epilogue
    fn.argtypes = [vp, vp, vp, i, i, f, f, i, i, i, i, i, i, i, i, vp]
    fn.restype = i
    fn = lib.raisr_filter_apply
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = i
    fn = lib.raisr_s8_matmul
    fn.argtypes = [vp, vp, vp, i, i, i, i, vp]
    fn.restype = i
    fn = lib.raisr_normal_eq
    fn.argtypes = [vp, vp, vp, vp, vp, vp, i, vp, vp, i, vp, vp, vp, i, i, i, vp]
    fn.restype = i
    fn = lib.raisr_cheap_upscale
    fn.argtypes = [vp, i, vp, i, i, i, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp, f, f, f, i, vp]
    fn.restype = i
    _LIB = lib
    return lib
