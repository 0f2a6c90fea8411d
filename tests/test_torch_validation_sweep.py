"""The port's validation sweep (raisr_tpu_torch.tools.validation_sweep) on the
CPU at the tool's size (32x24, 2 frames), on the seeded folders it writes:

  - every positive row, --shard rows included, through the port's CLI with
    --device cpu (backend auto, which is taps on the CPU, and pallas, the
    fused pass's plain version at the row's tier): exit 0, no marker, and
    the bytes of RaisrEngine(cfg, device="cpu").process frame by frame;
  - the float32 rows without --shard against raisr_tpu's CLI with the same
    flags on taps (--backend reference): header, frame markers, U and V
    byte-identical, Y under the cross-backend bar (under 2% of pixels
    differ, median 0);
  - every negative row and corrupt folder fails by the sweep's pass rule,
    with the exit code raisr_tpu's CLI gives on the same arguments;
  - the tool's own main (full, as `python -m`, and --quick) exits 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

from raisr_tpu.cli import main as jax_cli_main
from raisr_tpu_torch import RaisrEngine, video
from raisr_tpu_torch.tools import validation_sweep as vs
from torch_port_util import frac_and_median

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUZZ_FRAC = 0.02
H, W = 24, 32
ROWS = vs.positive_rows()
F32_ROWS = [r for r in ROWS if "--dtype" not in r[-1] and "--shard" not in r[-1]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: 32x24 planes gain nothing from more, and under
    pytest-xdist's workers the threads of every worker oversubscribe the
    cores (test_torch_sharding.py does the same)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    work = tmp_path_factory.mktemp("sweep")
    return str(work), vs.write_filter_folders(str(work / "filters"))


def _read(path):
    rd = video.Y4MReader(str(path))
    frames = list(rd)
    rd.close()
    return rd.fmt, frames


def _jax_cli(args):
    """raisr_tpu's CLI under the sweep's rules: (exit code, its output)."""
    rc, out, err = vs.run_cli(args, jax_cli_main)
    return rc, out + err


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("row", ROWS, ids=vs.row_name)
def test_positive_row_equals_engine(sweep, tmp_path, row, backend):
    work, root = sweep
    src, dst = vs.clip_for(work, row[2]), str(tmp_path / "out.y4m")
    rc, out, err = vs.run_cli(vs.upscale_argv(row, root, src, dst, backend, "cpu"))
    assert rc == 0 and vs.MARKER not in out + err, (out + err)[-500:]
    engine = RaisrEngine(vs.row_config(row, root, backend), device="cpu")
    fmt, got = _read(dst)
    out_h, out_w = engine.cfg.output_size(H, W)
    assert (fmt.width, fmt.height, fmt.bits, len(got)) == (out_w, out_h, row[2], 2)
    for fr, g in zip(_read(src)[1], got):
        want = engine.process(fr)
        for a, b in ((g.y, want.y), (g.u, want.u), (g.v, want.v)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert g.u.shape == engine.cfg.output_size(H // 2, W // 2)


@pytest.mark.parametrize("row", F32_ROWS, ids=vs.row_name)
def test_float32_row_against_jax_cli(sweep, tmp_path, row):
    work, root = sweep
    src = vs.clip_for(work, row[2])
    a, b = str(tmp_path / "port.y4m"), str(tmp_path / "jax.y4m")
    rc, out, err = vs.run_cli(vs.upscale_argv(row, root, src, a, "reference", "cpu"))
    assert rc == 0, (out + err)[-500:]
    rc, log = _jax_cli(vs.upscale_argv(row, root, src, b, "reference"))
    assert rc == 0, log[-500:]
    pa, pb = open(a, "rb").read(), open(b, "rb").read()
    header = pa.index(b"\n") + 1
    assert len(pa) == len(pb) and pa[:header] == pb[:header]
    fmt, fa = _read(a)
    fb = _read(b)[1]
    step = 6 + fmt.frame_bytes()
    assert len(pa) == header + len(fa) * step
    for k, (x, y) in enumerate(zip(fa, fb)):
        pos = header + k * step
        assert pa[pos:pos + 6] == pb[pos:pos + 6] == b"FRAME\n"
        assert np.array_equal(x.u, y.u) and np.array_equal(x.v, y.v)
        frac, med = frac_and_median(x.y, y.y)
        assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


def _negatives():
    return [desc for _, desc in vs.negative_cases("R", "W", "C")]


@pytest.mark.parametrize("desc", _negatives())
def test_negative_row_fails_as_in_jax(sweep, desc):
    work, root = sweep
    clip = vs.clip_for(work, 8)
    argv = dict((d, a) for a, d in vs.negative_cases(root, work, clip))[desc]
    rc, out, err = vs.run_cli(argv + ["--device", "cpu"])
    jax_rc, _ = _jax_cli(argv)
    assert rc != 0 and rc == jax_rc, (rc, jax_rc, (out + err)[-300:])


@pytest.mark.parametrize("name", list(vs.CORRUPT))
def test_corrupt_folder_fails_as_in_jax(sweep, name):
    work, root = sweep
    clip = vs.clip_for(work, 8)
    argv = ["upscale", "-i", clip, "-o", os.path.join(work, "neg.y4m"),
            "--filterfolder", vs.corrupt_folder(root, work, name)]
    rc, out, err = vs.run_cli(argv + ["--device", "cpu"])
    jax_rc, jax_log = _jax_cli(argv)
    assert rc != 0 and vs.MARKER in out + err, (rc, (out + err)[-300:])
    assert rc == jax_rc and vs.MARKER in jax_log


def test_main_module_full(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "raisr_tpu_torch.tools.validation_sweep", "--device", "cpu",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    n = len(ROWS) + len(_negatives()) + len(vs.CORRUPT)
    assert f"\n{n} passed, 0 failed" in r.stdout
    assert "SKIP" not in r.stdout  # the CPU serves the --shard rows


def test_main_quick(tmp_path, capsys):
    assert vs.main(["--device", "cpu", "--quick", "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"{3 + len(_negatives()) + len(vs.CORRUPT)} passed, 0 failed" in out


def test_default_device_is_the_card(tmp_path, capsys):
    """Without --device the sweep asks for the card: with none, every
    positive row fails with the engine's CUDA error and main returns 1; it
    never carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert vs.main(["--quick", "--workdir", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert f"{len(_negatives()) + len(vs.CORRUPT)} passed, 3 failed" in out
    assert out.count("CUDA is not available") == 3
