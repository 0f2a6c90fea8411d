"""The port's command line (`raisr-torch`, raisr_tpu_torch.cli.main) on the
CPU (--device cpu), on a generated bank folder and a generated clip: the
cases of tests/test_video_cli.py, the flags the port exposes, and the same
clip and folder through raisr_tpu's CLI on taps: header, frame markers, U and
V byte-identical, Y under the cross-backend bar (under 2% of pixels differ,
median 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

from raisr_tpu.cli import main as jax_cli_main
from raisr_tpu_torch import video
from raisr_tpu_torch.cli import main as cli_main
from torch_port_util import frac_and_median, write_bank_and_clip, write_bank_folder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUZZ_FRAC = 0.02
N, H, W = 5, 24, 32


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_bank_and_clip(tmp_path_factory.mktemp("cli"), n_frames=N, h=H, w=W, seed=7)


def _upscale(src, dst, folder, *extra):
    return cli_main(["upscale", "-i", str(src), "-o", str(dst), "--filterfolder", folder,
                     "--device", "cpu", *extra])


def _read(path):
    rd = video.Y4MReader(str(path))
    frames = list(rd)
    rd.close()
    return rd.fmt, frames


class TestUpscale:
    def test_upscale_y4m(self, assets, tmp_path, capsys):
        folder, clip, _ = assets
        dst = tmp_path / "out.y4m"
        assert _upscale(clip, dst, folder) == 0
        fmt, frames = _read(dst)
        assert (fmt.width, fmt.height, fmt.fps_num) == (2 * W, 2 * H, 25)
        assert len(frames) == N and frames[0].u.shape == (H, W)
        assert f"processed {N} frames {W}x{H} -> {2 * W}x{2 * H}" in capsys.readouterr().out

    @pytest.mark.parametrize("extra", [
        ("--batch", "3"), ("--batch", "3", "--pipeline-depth", "1"),
        ("--pipeline-depth", "4"), ("--backend", "pallas", "--batch", "2")])
    def test_batch_and_depth_leave_the_bytes_alone(self, assets, tmp_path, extra):
        """--batch and --pipeline-depth change the dispatch, never the output
        (on the taps path and on the fused pass's plain version alike)."""
        folder, clip, _ = assets
        backend = ("--backend", "pallas") if "pallas" in extra else ()
        a, b = tmp_path / "a.y4m", tmp_path / "b.y4m"
        assert _upscale(clip, a, folder, "--passes", "2", *backend) == 0
        assert _upscale(clip, b, folder, "--passes", "2", *extra) == 0
        assert a.read_bytes() == b.read_bytes()

    def test_frames_limit(self, assets, tmp_path):
        folder, clip, _ = assets
        dst = tmp_path / "out.y4m"
        assert _upscale(clip, dst, folder, "--frames", "2") == 0
        assert len(_read(dst)[1]) == 2

    def test_upscale_stdin_stdout_pipe(self, assets, tmp_path):
        """`raisr-torch upscale -i - -o -` streams Y4M through stdin/stdout
        byte-identically to the file path, keeping the pipe clean (banner and
        status line on stderr)."""
        folder, clip, _ = assets
        dst = tmp_path / "out.y4m"
        assert _upscale(clip, dst, folder) == 0
        env = dict(os.environ, PYTHONPATH=ROOT)
        with open(clip, "rb") as stdin:
            r = subprocess.run(
                [sys.executable, "-m", "raisr_tpu_torch.cli", "upscale", "-i", "-", "-o", "-",
                 "--filterfolder", folder, "--device", "cpu"],
                stdin=stdin, capture_output=True, env=env, timeout=600)
        assert r.returncode == 0, r.stderr.decode()[-500:]
        assert f"processed {N} frames".encode() in r.stderr  # status stays off the pipe
        assert b"raisr_tpu_torch v" in r.stderr  # and so does the banner
        assert r.stdout == dst.read_bytes()

    def test_upscale_raw_yuv(self, assets, tmp_path):
        folder = assets[0]
        src, dst = tmp_path / "in.yuv", tmp_path / "out.yuv"
        rng = np.random.default_rng(1)
        src.write_bytes(rng.integers(0, 255, size=(H * W * 3 // 2,)).astype(np.uint8).tobytes())
        assert _upscale(src, dst, folder, "--size", f"{W}x{H}") == 0
        assert dst.stat().st_size == 2 * H * 2 * W * 3 // 2
        # raw input without a size is refused
        assert _upscale(src, dst, folder) == 1

    @pytest.mark.parametrize("fmt", ["422", "444", "nv12", "mono"])
    def test_raw_formats(self, assets, tmp_path, fmt):
        """Chroma planes whose ratio to Y differs per axis, interleaved
        chroma, and no chroma at all."""
        folder = assets[0]
        in_fmt = video.VideoFormat(W, H, 8, fmt)
        src, dst = tmp_path / "in.yuv", tmp_path / "out.yuv"
        rng = np.random.default_rng(2)
        src.write_bytes(rng.integers(16, 235, in_fmt.frame_bytes() * 2).astype(np.uint8)
                        .tobytes())
        assert _upscale(src, dst, folder, "--size", f"{W}x{H}", "--format", fmt) == 0
        assert dst.stat().st_size == 2 * in_fmt.scaled(2 * H, 2 * W).frame_bytes()

    def test_upscale_10bit_y4m(self, tmp_path):
        folder, clip, _ = write_bank_and_clip(tmp_path, n_frames=2, seed=8, bits=10,
                                              subsampling="422")
        dst = tmp_path / "out.y4m"
        assert _upscale(clip, dst, folder, "--bits", "10") == 0
        fmt, frames = _read(dst)
        assert (fmt.bits, fmt.subsampling) == (10, "422")
        assert frames[0].y.dtype == np.uint16 and frames[0].u.shape == (2 * H, W)
        assert int(frames[0].y.max()) <= 1023

    def test_upscale_png(self, assets, tmp_path):
        pytest.importorskip("PIL")
        from PIL import Image

        src, dst = tmp_path / "in.png", tmp_path / "out.png"
        rng = np.random.default_rng(2)
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(src)
        assert _upscale(src, dst, assets[0], "--range", "full") == 0
        assert Image.open(dst).size == (2 * W, 2 * H)

    def test_evenoutput_15x(self, tmp_path):
        folder, clip, _ = write_bank_and_clip(tmp_path, n_frames=1, h=30, w=42, seed=9,
                                              passes=1, pixel_types=1)
        dst = tmp_path / "out.y4m"  # 1.5x -> 63x45 odd; evenoutput trims
        assert _upscale(clip, dst, folder, "--ratio", "1.5", "--evenoutput") == 0
        fmt = _read(dst)[0]
        assert (fmt.width, fmt.height) == (62, 44)

    @pytest.mark.parametrize("mode", ["cubic", "lanczos"])
    def test_resize_mode(self, assets, tmp_path, mode):
        folder, clip, _ = assets
        a, b = tmp_path / "bilinear.y4m", tmp_path / f"{mode}.y4m"
        assert _upscale(clip, a, folder) == 0
        assert _upscale(clip, b, folder, "--resize-mode", mode, "--batch", "2") == 0
        (_, fa), (fmt, fb) = _read(a), _read(b)
        assert (fmt.width, fmt.height) == (2 * W, 2 * H) and len(fb) == N
        assert not np.array_equal(fa[0].u, fb[0].u)  # chroma is the resize alone

    def test_backend_xla(self, assets, tmp_path):
        """The dense-conv backend against taps, through the CLI: chroma
        equal, Y under the bar."""
        folder, clip, _ = assets
        a, b = tmp_path / "taps.y4m", tmp_path / "xla.y4m"
        assert _upscale(clip, a, folder, "--backend", "reference", "--passes", "2") == 0
        assert _upscale(clip, b, folder, "--backend", "xla", "--passes", "2") == 0
        for fa, fb in zip(_read(a)[1], _read(b)[1]):
            assert np.array_equal(fa.u, fb.u) and np.array_equal(fa.v, fb.v)
            frac, med = frac_and_median(fa.y, fb.y)
            assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


class TestAgainstJaxCli:
    @pytest.mark.parametrize("extra", [(), ("--passes", "2", "--batch", "2"),
                                       ("--resize-mode", "cubic")])
    def test_same_clip_same_folder(self, assets, tmp_path, extra):
        folder, clip, _ = assets
        a, b = tmp_path / "port.y4m", tmp_path / "jax.y4m"
        assert _upscale(clip, a, folder, "--backend", "reference", *extra) == 0
        assert jax_cli_main(["upscale", "-i", clip, "-o", str(b), "--filterfolder", folder,
                             "--backend", "reference", *extra]) == 0
        pa, pb = a.read_bytes(), b.read_bytes()
        assert len(pa) == len(pb)
        header = pa.index(b"\n") + 1
        assert pa[:header] == pb[:header]
        ny, nc = 4 * H * W, H * W
        pos = header
        for _ in range(N):
            assert pa[pos: pos + 6] == pb[pos: pos + 6] == b"FRAME\n"
            pos += 6
            ya = np.frombuffer(pa[pos: pos + ny], np.uint8)
            yb = np.frombuffer(pb[pos: pos + ny], np.uint8)
            frac, med = frac_and_median(ya, yb)
            assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
            pos += ny
            assert pa[pos: pos + 2 * nc] == pb[pos: pos + 2 * nc]  # U and V
            pos += 2 * nc
        assert pos == len(pa)


class TestOtherCommands:
    def test_info(self, assets, capsys):
        assert cli_main(["info", "--filterfolder", assets[0], "--passes", "2"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["qangle"] == 24 and info["passes"] == 2
        assert info["banks"][1]["hashkey_size"] == 216 and info["banks"][0]["taps"] == 121

    def test_bad_filterfolder_fails_like_reference(self, tmp_path, capsys):
        assert cli_main(["info", "--filterfolder", str(tmp_path / "nonexistent")]) == 1
        assert "[RAISR ERROR]" in capsys.readouterr().err
        assert cli_main(["upscale", "-i", "x.y4m", "-o", "y.y4m", "--device", "cpu",
                         "--filterfolder", str(tmp_path / "nonexistent")]) == 1
        assert "[RAISR ERROR]" in capsys.readouterr().err

    def test_compare(self, assets, tmp_path, capsys):
        folder, clip, _ = assets
        assert cli_main(["compare", clip, clip, "--ssim"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["frames"] == N and out["psnr_y_db"] == float("inf")
        assert out["ssim_y"] == pytest.approx(1.0, abs=1e-4)
        other = write_bank_and_clip(tmp_path, n_frames=N, h=H, w=W, seed=8)[1]
        assert cli_main(["compare", clip, other, "--frames", "2"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["frames"] == 2 and 0 < out["psnr_y_db"] < 60
        big = write_bank_and_clip(tmp_path / "big", n_frames=1, h=2 * H, w=W, seed=8)[1]
        assert cli_main(["compare", clip, big]) == 1  # frame size mismatch
        assert "[RAISR ERROR]" in capsys.readouterr().err

    @pytest.mark.parametrize("latency", [False, True])
    def test_bench(self, assets, capsys, latency):
        argv = ["bench", "--width", "32", "--height", "24", "--frames", "2", "--device",
                "cpu", "--filterfolder", assets[0]] + (["--latency"] if latency else [])
        assert cli_main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["device"] == "cpu"
        if latency:
            assert out["fenced_ms_per_frame"] > 0 and out["pipelined_fps"] > 0
        else:
            assert out["unit"] == "frames/sec" and out["value"] > 0
            assert "32x24->(64, 48)" in out["metric"]

    def test_train_refused_naming_the_roadmap_item(self, tmp_path, capsys):
        """`raisr-torch train --device cpu` and raisr_tpu's `raisr train` on the
        same clip (tests/test_train.py's hold-out clip: 10 frames of 64x48,
        every 5th held out): the banks agree within the JAX package's
        tolerance (rtol 2e-3, atol 2e-4, at --lam 0.05; filters a
        hash-flipped pixel reached are left out, see test_torch_train.py),
        the hold-out reports have the same keys and PSNRs within 0.05 dB.
        Without --device the command needs the card: with none it returns 1
        with the CUDA RaisrError and writes nothing."""
        import torch

        from raisr_tpu.model.loader import load_model as jax_load_model
        from raisr_tpu.config import RaisrConfig as JaxRaisrConfig
        from raisr_tpu.train import trainer as jt
        from raisr_tpu_torch import RaisrConfig, load_model
        from raisr_tpu_torch.engine import Frame
        from raisr_tpu_torch.train import trainer as pt
        from torch_port_util import hash_agreement

        rng = np.random.default_rng(5)
        src = str(tmp_path / "hr.y4m")
        w, h, n = 64, 48, 10
        wr = video.Y4MWriter(src, video.VideoFormat(w, h, 8, "420"))
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        hrs = []
        for i in range(n):
            img = (110 + 70 * np.sin((x + 3 * i) / 7.0) + 50 * (y > h // 2)
                   + rng.normal(0, 5, (h, w)))
            hrs.append(np.clip(img, 16, 235).astype(np.uint8))
            u = np.full((h // 2, w // 2), 128, np.uint8)
            wr.write(Frame(y=hrs[-1], u=u, v=u))
        wr.close()

        def train(main, folder, *extra):
            argv = ["train", "-o", str(tmp_path / folder), "-i", src, "--eval-holdout", "5",
                    "--lam", "0.05", *extra]
            assert main(argv) == 0
            out = capsys.readouterr().out
            return json.loads([ln for ln in out.splitlines() if '"eval"' in ln][-1])["eval"]

        port = train(cli_main, "port", "--device", "cpu")
        jax_report = train(jax_cli_main, "jax")
        assert port.keys() == jax_report.keys() == {
            "holdout_frames", "trained_psnr_db", "bilinear_psnr_db"}
        assert port["holdout_frames"] == jax_report["holdout_frames"] == 2
        for key in ("trained_psnr_db", "bilinear_psnr_db"):
            assert abs(port[key] - jax_report[key]) <= 0.05, (key, port, jax_report)
        bank = load_model(str(tmp_path / "port"),
                          RaisrConfig(filterfolder=str(tmp_path / "port"))).banks[0]
        jax_bank = jax_load_model(str(tmp_path / "jax"),
                                  JaxRaisrConfig(filterfolder=str(tmp_path / "jax"))).banks[0]
        pairs = [pt.degrade(f, 2.0, 8) for i, f in enumerate(hrs) if i % 5 != 4]
        rows, flipped = hash_agreement(pairs, jt.TrainConfig(lam=0.05),
                                       pt.TrainConfig(lam=0.05))
        assert flipped < 0.02, flipped  # the cross-backend bar
        np.testing.assert_allclose(bank.filters[rows], np.asarray(jax_bank.filters)[rows],
                                   rtol=2e-3, atol=2e-4)

        if not torch.cuda.is_available():
            assert cli_main(["train", "-o", str(tmp_path / "card"), "-i", src]) == 1
            assert "device cuda requested but CUDA is not available" in capsys.readouterr().err
            assert not (tmp_path / "card").exists()

    def test_shard_reaches_the_engines_refusal(self, assets, tmp_path, capsys):
        """--shard is served (on the CPU: a mesh of CPU entries) and leaves
        the bytes alone, frame by frame (batch 1) and in row stripes in
        groups (batch 2, the tail of 1 padded); a spec the clip cannot take
        is refused."""
        folder, clip, _ = assets
        base = tmp_path / "base.y4m"
        assert _upscale(clip, base, folder, "--passes", "2") == 0
        for i, extra in enumerate([("--shard", "data=2"),
                                   ("--shard", "data=2,rows=2", "--batch", "2")]):
            dst = tmp_path / f"o{i}.y4m"
            assert _upscale(clip, dst, folder, "--passes", "2", *extra) == 0, extra
            assert dst.read_bytes() == base.read_bytes(), extra
        capsys.readouterr()
        # 24 LR rows in 4 stripes of 6: the pass at HR runs, but pass 2
        # at LR (mode 2) needs a halo of 8 rows
        assert _upscale(clip, tmp_path / "bad.y4m", folder, "--passes", "2", "--mode", "2",
                        "--shard", "rows=4") == 1
        assert "stripe" in capsys.readouterr().err

    def test_default_device_is_the_card(self, assets, tmp_path, capsys):
        """No --device means cuda: without a card the CLI fails with a
        RaisrError and writes no clip; it never carries on on the CPU."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        folder, clip, _ = assets
        dst = tmp_path / "out.y4m"
        assert cli_main(["upscale", "-i", clip, "-o", str(dst), "--filterfolder", folder]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert not dst.exists()
        assert cli_main(["bench", "--frames", "1", "--filterfolder", folder]) == 1


def test_new_modules_import_no_jax(tmp_path):
    """The serving and training modules, imported and run end to end in a
    fresh process, pull in neither jax nor anything of raisr_tpu."""
    folder = write_bank_folder(tmp_path / "bank", passes=1, seed=3)
    code = (
        "import sys, numpy as np\n"
        "import raisr_tpu_torch\n"
        "from raisr_tpu_torch import stream, video, io_native, cli\n"
        "from raisr_tpu_torch.utils import metrics, profiler\n"
        "from raisr_tpu_torch.ops import filter_apply, resize\n"
        "from raisr_tpu_torch.train import trainer\n"
        "from raisr_tpu_torch.ops.cuda import normal_eq\n"
        "from raisr_tpu_torch.tools import validation_sweep\n"
        "pairs = [trainer.degrade(np.arange(32 * 40).reshape(32, 40) % 251, 2.0, 8)]\n"
        "trainer.train_filterbank(pairs, trainer.TrainConfig(), device='cpu')\n"
        f"rc = cli.main(['bench', '--width', '32', '--height', '24', '--frames', '1',\n"
        f"               '--device', 'cpu', '--filterfolder', {folder!r}])\n"
        "assert rc == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'raisr_tpu' or m.startswith('raisr_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_JAX_OK" in r.stdout
