"""The port's C ABI on the CPU: raisr_tpu_torch.capi_bridge on its own and
against raisr_tpu.capi_bridge on the same strided frame, and the library
build/capi_torch/libraisr_tpu.so (raisr_tpu_torch.native.build_capi) driven
in process through ctypes and by the repository's C consumers, unchanged:
tools/capi_smoke.c, tools/capi_y4m.c and the FFmpeg filter
ffmpeg/vf_raisr_tpu.c under ffmpeg/shim_harness.c, held against the port's
CLI byte for byte. A C host asks for the CPU with RAISR_TPU_TORCH_DEVICE=cpu;
without it and without a card, Init is refused with the engine's message.
Banks and clips are written under tmp_path.
"""

import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import raisr_tpu_torch
from raisr_tpu import capi_bridge as jax_bridge
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch import capi_bridge as cb
from raisr_tpu_torch.cli import main as cli_main
from raisr_tpu_torch.native import build_capi
from raisr_tpu_torch.ops.pipeline import pass_statics
from torch_port_util import (StridedFrame, frac_and_median, write_bank_folder,
                             write_y4m_clip)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUZZ_FRAC = 0.02
H, W = 24, 32
NO_CARD = "[RAISR ERROR] device cuda requested but CUDA is not available."
TIMEOUT = 120


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    root = tmp_path_factory.mktemp("capi")
    return {8: write_bank_folder(root / "bank8", passes=2, seed=3),
            10: write_bank_folder(root / "bank10", passes=2, seed=4, bits=10)}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(cb.DEVICE_ENV, "cpu")
    monkeypatch.setattr(cb, "_device_index", None)
    yield
    cb.deinit()


@pytest.fixture(scope="module")
def lib_dir():
    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    return os.path.dirname(build_capi.build())


def _c_env(lib_dir, device="cpu"):
    env = dict(os.environ, LD_LIBRARY_PATH=lib_dir)
    env.pop(cb.DEVICE_ENV, None)
    if device:
        env[cb.DEVICE_ENV] = device
    return env


def _assert_frame(got, want):
    for g, w in zip(got, (want.y, want.u, want.v)):
        np.testing.assert_array_equal(g, w)


class TestBridge:
    def test_init_process_deinit(self, banks, on_cpu):
        assert cb.init(banks[8], 2.0, 8, 0, 2, 1) == 0
        assert cb._engine.device.type == "cpu"
        fr = StridedFrame(seed=1)
        assert cb.process(*fr.args(), 2) == 0
        want = RaisrEngine(RaisrConfig(filterfolder=banks[8], passes=2),
                           device="cpu").process(fr.frame())
        _assert_frame(fr.got(), want)
        assert cb.deinit() == 0
        assert cb._engine is None

    def test_bad_model_path(self, on_cpu, tmp_path):
        assert cb.init(str(tmp_path / "nonexistent"), 2.0, 8, 0, 1, 1) == 1
        assert cb._engine is None

    def test_process_before_init(self, capsys):
        cb.deinit()
        assert cb.process(None, None, None, None, None, None, 2) == 1
        assert "[RAISR ERROR] RTPU_Process called before RTPU_Init" in capsys.readouterr().out

    def test_step_shorter_than_the_row_is_refused(self, banks, on_cpu, capsys):
        assert cb.init(banks[8], 2.0, 8, 0, 1, 1) == 0
        fr = StridedFrame(seed=2)
        args = fr.args()
        addr, w, h, _ = args[0]
        assert cb.process((addr, w, h, w - 1), *args[1:], 2) == 1
        assert "[RAISR ERROR] plane step" in capsys.readouterr().out

    @pytest.mark.parametrize("tier,dtype", [(0, "float32"), (1, "bfloat16"), (2, "int8")])
    def test_tier_selects_the_dtype(self, banks, on_cpu, tier, dtype):
        """RTPU_InitEx's tier (the analogue of the reference ABI's asmType)
        sets the engine's dtype; the CPU resolves `auto` to taps, which runs
        no tier, and the fused backend runs the tier of that dtype."""
        assert cb.init(banks[8], 2.0, 8, 0, 1, 1, tier=tier) == 0
        assert cb._cfg.dtype == dtype
        assert cb._engine._statics.tier == pass_statics(cb._cfg, cb._engine.model,
                                                        cb._engine._backend).tier
        assert pass_statics(cb._cfg, cb._engine.model, "pallas").tier == dtype

    def test_blending_engine_built_once_sharing_the_model(self, banks, on_cpu):
        assert cb.init(banks[8], 2.0, 8, 0, 1, 1) == 0
        fr = StridedFrame(seed=3)
        assert cb.process(*fr.args(), 1) == 0
        eng = cb._engines_by_blend[1]
        assert eng is not cb._engine
        assert eng.model is cb._engine.model and eng.device == cb._engine.device
        out = fr.fresh_out()
        assert cb.process(*fr.args(out), 1) == 0
        assert cb._engines_by_blend[1] is eng and len(cb._engines_by_blend) == 2
        want = RaisrEngine(RaisrConfig(filterfolder=banks[8], blending=1),
                           device="cpu").process(fr.frame())
        _assert_frame(fr.got(), want)
        _assert_frame(fr.got(out), want)

    def test_set_device(self, on_cpu, monkeypatch):
        """On the CPU one index is valid; on the card the count is
        torch.cuda.device_count()."""
        assert cb.set_device(0) == 0 and cb._device_index == 0
        assert cb.set_device(1) != 0
        assert cb.set_device(10_000) != 0
        monkeypatch.delenv(cb.DEVICE_ENV)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert cb.set_device(1) == 0 and cb._device_index == 1
        assert cb.set_device(2) != 0

    def test_init_refused_without_a_card(self, banks, on_cpu, monkeypatch, capsys):
        """No card and no request for the CPU: 1 and the engine's message,
        no fallback to the CPU."""
        monkeypatch.delenv(cb.DEVICE_ENV)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert cb.init(banks[8], 2.0, 8, 0, 1, 1) == 1
        assert NO_CARD in capsys.readouterr().out
        assert cb._engine is None

    def test_device_argument_overrides_the_environment(self, banks, on_cpu, monkeypatch):
        monkeypatch.setenv(cb.DEVICE_ENV, "cuda")
        assert cb.init(banks[8], 2.0, 8, 0, 1, 1, device="cpu") == 0
        assert cb._engine.device == torch.device("cpu")


@pytest.mark.parametrize("bits,passes", [(8, 2), (10, 1)])
def test_bridge_against_jax_bridge(banks, on_cpu, bits, passes):
    """The same strided frame and folder through both bridges: U and V
    byte-identical, Y under the cross-backend bar."""
    fr = StridedFrame(bits=bits, seed=5)
    out_jax = fr.fresh_out()
    try:
        assert cb.init(banks[bits], 2.0, bits, 0, passes, 1) == 0
        assert jax_bridge.init(banks[bits], 2.0, bits, 0, passes, 1) == 0
        assert cb.process(*fr.args(), 2) == 0
        assert jax_bridge.process(*fr.args(out_jax), 2) == 0
    finally:
        cb.deinit()
        jax_bridge.deinit()
    got, want = fr.got(), fr.got(out_jax)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    frac, med = frac_and_median(got[0], want[0])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


# -- the built library -------------------------------------------------------


def _header_version() -> str:
    hdr = open(os.path.join(ROOT, "include", "raisr_tpu.h")).read()
    return ".".join(re.search(rf"#define RAISR_TPU_VERSION_{k} (\d+)", hdr).group(1)
                    for k in ("MAJOR", "MINOR", "PATCH"))


def test_library_version(lib_dir):
    lib = build_capi.load()
    assert lib.RTPU_Version().decode() == raisr_tpu_torch.__version__ == _header_version()


def test_library_in_process_and_from_a_second_thread(lib_dir, banks, on_cpu):
    """Loaded into this interpreter: Init, SetRes and Process over ctypes,
    equal to engine.process; the same call from another thread returns the
    same bytes (ctypes gives the GIL up, the library takes it back); the
    error codes of a bad device index, a missing folder and Process after
    Deinit."""
    lib = build_capi.load()
    fr = StridedFrame(seed=6)
    try:
        assert lib.RTPU_SetDevice(0) == 0
        assert lib.RTPU_InitEx(banks[8].encode(), 2.0, 8, 0, 2, 1, 0) == 0
        assert lib.RTPU_SetRes(*fr.rtpu()) == 0
        assert lib.RTPU_Process(*fr.rtpu(), 2) == 0
        want = RaisrEngine(RaisrConfig(filterfolder=banks[8], passes=2),
                           device="cpu").process(fr.frame())
        _assert_frame(fr.got(), want)
        out = fr.fresh_out()
        rc = []
        t = threading.Thread(target=lambda: rc.append(lib.RTPU_Process(*fr.rtpu(out), 2)),
                             daemon=True)
        t.start()
        t.join(60)
        assert not t.is_alive() and rc == [0]
        _assert_frame(fr.got(out), want)

        assert lib.RTPU_SetDevice(1) == 0  # stored; checked at Init
        assert lib.RTPU_InitEx(banks[8].encode(), 2.0, 8, 0, 2, 1, 0) == 1
        assert lib.RTPU_SetDevice(-1) == 1
        assert lib.RTPU_SetDevice(0) == 0
        assert lib.RTPU_Init(b"/nonexistent/bank", 2.0, 8, 0, 1, 1) != 0
        assert lib.RTPU_Init(banks[8].encode(), 2.0, 8, 0, 1, 1) == 0
    finally:
        assert lib.RTPU_Deinit() == 0
    assert lib.RTPU_Process(*fr.rtpu(), 2) != 0


@pytest.mark.parametrize("device,rc", [("cpu", 0), (None, 1)])
def test_capi_smoke(lib_dir, banks, device, rc):
    """tools/capi_smoke.c: 0 on the CPU when asked for; without the request
    and without a card, Init fails with the engine's message."""
    r = subprocess.run([os.path.join(lib_dir, "capi_smoke"), banks[8]], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_c_env(lib_dir, device))
    assert r.returncode == rc, r.stdout + r.stderr
    if rc:
        assert NO_CARD in r.stdout


@pytest.mark.parametrize("bits,passes", [(8, 2), (10, 1)])
def test_capi_y4m_equals_cli(lib_dir, banks, tmp_path, bits, passes):
    """tools/capi_y4m.c (the frame-by-frame consumer an FFmpeg filter would
    be) writes the bytes `python -m raisr_tpu_torch.cli upscale` writes."""
    clip = str(tmp_path / "in.y4m")
    write_y4m_clip(clip, 2, H, W, seed=8, bits=bits)
    out_c, out_cli = str(tmp_path / "capi.y4m"), str(tmp_path / "cli.y4m")
    r = subprocess.run([os.path.join(lib_dir, "capi_y4m"), clip, out_c, banks[bits], "2",
                        str(bits), "0", str(passes), "1", "2"],
                       capture_output=True, text=True, timeout=TIMEOUT, env=_c_env(lib_dir))
    assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run([sys.executable, "-m", "raisr_tpu_torch.cli", "upscale", "-i", clip,
                        "-o", out_cli, "--passes", str(passes), "--bits", str(bits),
                        "--filterfolder", banks[bits], "--device", "cpu"],
                       capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert open(out_c, "rb").read() == open(out_cli, "rb").read()


@pytest.fixture(scope="module")
def shim(lib_dir, banks, tmp_path_factory):
    """The shim filter against the port's library, an 8-bit and a 10-bit
    clip of width 52 (linesize 64 > width) and the CLI's outputs of both."""
    path = build_capi.build_shim_filter()
    if path is None:
        pytest.skip("libavutil headers not found")
    root = tmp_path_factory.mktemp("shim")
    clips, want = {}, {}
    for bits, passes in ((8, 2), (10, 1)):
        clips[bits] = str(root / f"in{bits}.y4m")
        write_y4m_clip(clips[bits], 2 if bits == 8 else 1, 40, 52, seed=9, bits=bits)
        out = str(root / f"cli{bits}.y4m")
        assert cli_main(["upscale", "-i", clips[bits], "-o", out, "--passes", str(passes),
                         "--bits", str(bits), "--filterfolder", banks[bits],
                         "--device", "cpu"]) == 0
        want[bits] = open(out, "rb").read()
    return str(path), clips, want


@pytest.mark.parametrize("bits,bank_bits,opts,expect", [
    (8, 8, "ratio=2:passes=2", None),
    # a verbatim vf_raisr-style line drops in: string range, asm= of an
    # f32-grade value, platform and threadcount accepted (vf_raisr.c:82-93)
    (8, 8, "ratio=2:passes=2:range=video:asm=avx512:platform=0:threadcount=20", None),
    (8, 8, "ratio=2:range=limited", b"unknown range"),
    (8, 8, "ratio=2:asm=avx512f16", b"unknown asm"),
    # Init succeeds on a 10-bit bank; the 8-bit frames are then refused
    (8, 10, "ratio=2:bits=10", b"bits=8"),
    (10, 10, "ratio=2:bits=10:passes=1", None),
], ids=["plain", "vf_raisr_line", "bad_range", "bad_asm", "bad_bits", "10bit"])
def test_ffmpeg_filter_via_shim_harness(shim, banks, tmp_path, bits, bank_bits, opts, expect):
    """ffmpeg/vf_raisr_tpu.c executed against the port's library: its output
    equals the CLI's byte for byte; a bad option is refused loudly."""
    path, clips, want = shim
    out = str(tmp_path / "out.y4m")
    r = subprocess.run([path, clips[bits], out, f"{opts}:filterfolder={banks[bank_bits]}"],
                       capture_output=True, timeout=TIMEOUT,
                       env=_c_env(os.path.dirname(path)))
    if expect is None:
        assert r.returncode == 0, r.stderr.decode()[-500:]
        assert open(out, "rb").read() == want[bits]
    else:
        assert r.returncode != 0 and expect in r.stderr


SECOND_THREAD_HOST = r"""
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "raisr_tpu.h"

enum { W = 32, H = 24 };
static unsigned char in_y[W * H], out_main[4 * W * H], out_thread[4 * W * H];
static RTPUStatus thread_rc = RTPU_ERROR_UNDEFINED;

static RTPUStatus process(unsigned char* out) {
  RTPUPlane inp = {in_y, W, H, W}, outp = {out, 2 * W, 2 * H, 2 * W};
  return RTPU_Process(&inp, NULL, NULL, &outp, NULL, NULL,
                      RTPU_BLEND_COUNT_OF_BITS_CHANGED);
}

static void* worker(void* arg) {
  (void)arg;
  thread_rc = process(out_thread);
  return NULL;
}

int main(int argc, char** argv) {
  for (int i = 0; i < W * H; ++i) in_y[i] = (unsigned char)(16 + (i * 7) % 200);
  if (RTPU_Init(argv[1], 2.0f, 8, RTPU_RANGE_VIDEO, 2, 1) != RTPU_OK) return 1;
  pthread_t t;  /* the first Process comes from another thread than Init */
  if (pthread_create(&t, NULL, worker, NULL) || pthread_join(t, NULL)) return 2;
  if (thread_rc != RTPU_OK) return 3;
  if (process(out_main) != RTPU_OK) return 4;
  if (memcmp(out_main, out_thread, sizeof out_main)) return 5;
  RTPU_Deinit();
  printf("second thread ok\n");
  return 0;
}
"""


def test_process_from_a_second_host_thread(lib_dir, banks, tmp_path):
    """A C host calls Init on its main thread and the first Process on a
    pthread: the library started the interpreter and gave the GIL back, so
    the call returns, with the bytes the main thread then gets."""
    src, exe = tmp_path / "host.c", str(tmp_path / "host")
    src.write_text(SECOND_THREAD_HOST)
    subprocess.run(["cc", str(src), "-o", exe, "-pthread", f"-I{ROOT}/include", f"-L{lib_dir}",
                    "-lraisr_tpu"], check=True, capture_output=True, timeout=TIMEOUT)
    r = subprocess.run([exe, banks[8]], capture_output=True, text=True, timeout=TIMEOUT,
                       env=_c_env(lib_dir))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "second thread ok" in r.stdout
