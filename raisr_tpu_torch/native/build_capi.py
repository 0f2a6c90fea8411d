"""Build the port's C ABI and the repository's C consumers from the checkout.

`build()` compiles `raisr_tpu_torch/native/capi.cpp` with the host C++
compiler against the running interpreter's headers and its shared libpython
(the flags `python3-config --includes` and `--embed --ldflags` print, read
from sysconfig) into `build/capi_torch/libraisr_tpu.so` at the root of the
checkout, and compiles `tools/capi_smoke.c` and `tools/capi_y4m.c`, as they
are, beside it with `-Lbuild/capi_torch -lraisr_tpu`. The library keeps
raisr_tpu's name, so the FFmpeg patch's `-lraisr_tpu` and every tool's link
line take the port through `-L` / `LD_LIBRARY_PATH` alone, and the JAX
package's library in `build/capi/` is never touched. `build_shim_filter()`
compiles the FFmpeg filter `ffmpeg/vf_raisr_tpu.c` with the functional
mini-libavfilter `ffmpeg/shim_harness.c` against it, as
`ffmpeg/shim_filter_build.sh` does against `build/capi`, where libavutil's
headers are found.

Each build is skipped when the hash of its sources and command lines matches
the stamp beside its outputs; otherwise it runs in a temporary directory and
the outputs are renamed into place, so a concurrent loader never sees a
half-written library. Nothing here runs at import time. `load()` builds
the library and loads it with ctypes into the running process, where it
drives the interpreter that already runs.

    python -m raisr_tpu_torch.native.build_capi    # build all, print the paths
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sysconfig
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "capi_torch"
LIB_NAME = "libraisr_tpu.so"
CAPI_SRC = ROOT / "raisr_tpu_torch" / "native" / "capi.cpp"
HEADER = ROOT / "include" / "raisr_tpu.h"
TOOLS = ("capi_smoke", "capi_y4m")
SHIM = "shim_filter"
AVUTIL_DIRS = ("/usr/include/x86_64-linux-gnu", "/usr/include")


def _compiler(env: str, *names: str) -> str:
    found = os.environ.get(env) or next(filter(None, map(shutil.which, names)), None)
    if not found:
        raise RuntimeError(f"no {env} compiler found (${env}, {', '.join(names)}): the "
                           "raisr_tpu_torch C ABI cannot be built.")
    return found


def _python_flags() -> tuple[list[str], list[str]]:
    """(compile, link) flags that embed the running interpreter. Refuses a
    Python without a shared libpython: a library carrying its own static copy
    would start a second interpreter inside a Python host."""
    var = sysconfig.get_config_var
    if not var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            "the raisr_tpu_torch C ABI needs a Python built with a shared libpython "
            f"(--enable-shared); this one links it statically ({var('LDLIBRARY')}).")
    paths = sysconfig.get_paths()
    includes = dict.fromkeys((paths["include"], paths["platinclude"]))
    libdir = var("LIBDIR")
    return ([f"-I{d}" for d in includes],
            [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-lpython{var('LDVERSION')}",
             *var("LIBS").split(), *var("SYSLIBS").split()])


def _digest(cmds: list[list[str]], sources) -> str:
    h = hashlib.sha256(repr(cmds).encode())
    for src in sources:
        h.update(str(src).encode())
        h.update(pathlib.Path(src).read_bytes())
    return h.hexdigest()


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"compiler failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")


def _build(outputs: list[str], cmds, sources, stamp_name: str) -> None:
    """Run the command lines `cmds(tmp)` in a temporary directory `tmp`
    unless the stamp matches, then rename `outputs` from it into BUILD_DIR,
    in order."""
    digest = _digest(cmds("OUT"), sources)
    stamp = BUILD_DIR / stamp_name
    if (stamp.is_file() and stamp.read_text() == digest
            and all((BUILD_DIR / o).is_file() for o in outputs)):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for cmd in cmds(tmp):
            _run(cmd)
        for o in outputs:
            os.replace(os.path.join(tmp, o), BUILD_DIR / o)
    stamp.write_text(digest)


def build() -> pathlib.Path:
    """Build `libraisr_tpu.so`, `capi_smoke` and `capi_y4m` into BUILD_DIR
    unless they match their sources. Returns the library's path."""
    py_inc, py_ld = _python_flags()
    cxx, cc = _compiler("CXX", "c++", "g++"), _compiler("CC", "cc", "gcc")

    def cmds(out: str) -> list[list[str]]:
        lib = [cxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-Wall", *py_inc, str(CAPI_SRC),
               "-o", f"{out}/{LIB_NAME}", *py_ld]
        return [lib] + [[cc, "-O2", str(ROOT / "tools" / f"{t}.c"), f"-I{HEADER.parent}",
                         f"-L{out}", "-lraisr_tpu", "-o", f"{out}/{t}"] for t in TOOLS]

    _build([LIB_NAME, *TOOLS], cmds,
           [CAPI_SRC, HEADER, *(ROOT / "tools" / f"{t}.c" for t in TOOLS)], "capi.sha256")
    return BUILD_DIR / LIB_NAME


def build_shim_filter() -> pathlib.Path | None:
    """Build `shim_filter` (the FFmpeg filter driven by the shim harness)
    against the port's library; None where libavutil's headers are missing,
    as `ffmpeg/shim_filter_build.sh` exits 77 there."""
    avutil = next((d for d in AVUTIL_DIRS
                   if pathlib.Path(d, "libavutil", "frame.h").is_file()), None)
    if avutil is None:
        return None
    build()
    ff = ROOT / "ffmpeg"
    srcs = [ff / "vf_raisr_tpu.c", ff / "shim_harness.c"]
    gcc = _compiler("CC", "gcc", "cc")

    def cmds(out: str) -> list[list[str]]:
        return [[gcc, *map(str, srcs), "-o", f"{out}/{SHIM}", "-std=c11", "-Wall", "-Werror",
                 "-Wno-unused-function", f"-I{ff / 'compile_shim'}", f"-I{avutil}",
                 f"-I{HEADER.parent}", f"-L{BUILD_DIR}", "-lraisr_tpu", "-lavutil"]]

    _build([SHIM], cmds, [*srcs, *sorted((ff / "compile_shim").glob("*.h"))], "shim.sha256")
    return BUILD_DIR / SHIM


class RTPUPlane(ctypes.Structure):
    """The header's RTPUPlane: one plane of uint8 or little-endian uint16
    samples, `step` bytes a row."""
    _fields_ = [("data", ctypes.c_void_p), ("width", ctypes.c_uint),
                ("height", ctypes.c_uint), ("step", ctypes.c_uint)]


def load() -> ctypes.CDLL:
    """Build if needed, load the library, and declare every entry point's C
    signature."""
    lib = ctypes.CDLL(str(build()))
    u, st, pp = ctypes.c_uint, ctypes.c_int, ctypes.POINTER(RTPUPlane)
    init = (ctypes.c_char_p, ctypes.c_float, u, st, u, u)
    for name, args in (("RTPU_Init", init), ("RTPU_InitEx", init + (st,)),
                       ("RTPU_SetDevice", (st,)), ("RTPU_SetRes", (pp,) * 6),
                       ("RTPU_Process", (pp,) * 6 + (st,)), ("RTPU_Deinit", ())):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(args), st
    lib.RTPU_Version.argtypes, lib.RTPU_Version.restype = [], ctypes.c_char_p
    return lib


if __name__ == "__main__":
    print(build())
    for tool in TOOLS:
        print(BUILD_DIR / tool)
    print(build_shim_filter() or "shim_filter skipped: libavutil headers not found")
