"""The port's video I/O, native-I/O fallbacks and metrics: the round trips of
tests/test_video_cli.py and tests/test_native_io.py against the port, and the
port against raisr_tpu: a file written by one package is read by the other,
byte for byte, for every subsampling and both depths.
"""

import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import raisr_tpu.engine as jengine
import raisr_tpu.io_native as jio
import raisr_tpu.utils.metrics as jmetrics
import raisr_tpu.video as jvideo
from raisr_tpu_torch import RaisrError, io_native, video
from raisr_tpu_torch.engine import Frame
from raisr_tpu_torch.utils import metrics
from torch_port_util import write_y4m_clip

SUBSAMPLINGS = ["420", "422", "444", "mono"]


def _frames(n, w, h, bits, subsampling, seed=0, frame_cls=Frame):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits == 8 else np.uint16
    hi = (1 << bits) - 1
    out = []
    for _ in range(n):
        y = rng.integers(0, hi, (h, w)).astype(dt)
        if subsampling == "mono":
            out.append(frame_cls(y=y))
            continue
        sv, sh = {"420": (2, 2), "422": (1, 2), "444": (1, 1), "nv12": (2, 2)}[subsampling]
        out.append(frame_cls(y=y, u=rng.integers(0, hi, (h // sv, w // sh)).astype(dt),
                             v=rng.integers(0, hi, (h // sv, w // sh)).astype(dt)))
    return out


def _write(mod, path, fmt_args, frames, raw=False):
    fmt = mod.VideoFormat(*fmt_args)
    wr = (mod.RawYUVWriter if raw else mod.Y4MWriter)(str(path), fmt)
    for f in frames:
        wr.write(f)
    wr.close()
    return fmt


def _planes_equal(a, b):
    return all((p is None and q is None) or np.array_equal(p, q)
               for p, q in ((a.y, b.y), (a.u, b.u), (a.v, b.v)))


class TestY4M:
    @pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
    @pytest.mark.parametrize("bits", [8, 10, 16])
    def test_roundtrip(self, tmp_path, subsampling, bits):
        path = tmp_path / "clip.y4m"
        frames = _frames(2, 32, 24, bits, subsampling)
        _write(video, path, (32, 24, bits, subsampling), frames)
        rd = video.Y4MReader(str(path))
        assert (rd.fmt.width, rd.fmt.height) == (32, 24)
        assert rd.fmt.bits == bits and rd.fmt.subsampling == subsampling
        got = list(rd)
        rd.close()
        assert len(got) == 2
        assert all(_planes_equal(a, b) for a, b in zip(got, frames))
        assert got[0].y.dtype == (np.uint8 if bits == 8 else np.uint16)

    def test_rejects_garbage(self, tmp_path):
        p = tmp_path / "bad.y4m"
        p.write_bytes(b"not a y4m stream\n")
        with pytest.raises(RaisrError, match="Y4M"):
            video.Y4MReader(str(p))

    def test_header_errors(self, tmp_path):
        for i, header in enumerate((b"YUV4MPEG2 W32\n", b"YUV4MPEG2 W32 H24 C411\n",
                                    b"YUV4MPEG2 W32 H24 C420p9\n")):
            p = tmp_path / f"h{i}.y4m"
            p.write_bytes(header)
            with pytest.raises(RaisrError):
                video.Y4MReader(str(p))
        p = tmp_path / "marker.y4m"
        p.write_bytes(b"YUV4MPEG2 W4 H2 C420\nFRAMX\n" + bytes(12))
        with pytest.raises(RaisrError, match="FRAME"):
            list(video.Y4MReader(str(p)))

    def test_scaled_header_and_stream_objects(self):
        """Y4MWriter writes the scaled header (VideoFormat.scaled); readers
        and writers take open binary streams as well as paths."""
        fmt = video.VideoFormat(32, 24, 10, "422", 30000, 1001)
        out = fmt.scaled(48, 64)
        assert (out.width, out.height, out.bits, out.subsampling) == (64, 48, 10, "422")
        buf = io.BytesIO()
        wr = video.Y4MWriter(buf, out)
        frame = _frames(1, 64, 48, 10, "422")[0]
        wr.write(frame)
        wr.close()  # a stream the writer does not own stays open
        assert buf.getvalue().startswith(b"YUV4MPEG2 W64 H48 F30000:1001 Ip A1:1 C422p10\n")
        buf.seek(0)
        rd = video.Y4MReader(buf)
        assert rd.fmt == out
        assert _planes_equal(next(iter(rd)), frame)

    def test_truncated_last_frame_dropped(self, tmp_path):
        path = tmp_path / "cut.y4m"
        fmt = _write(video, path, (16, 8, 8, "420"), _frames(3, 16, 8, 8, "420"))
        data = path.read_bytes()
        path.write_bytes(data[: len(data) - 7])
        assert len(list(video.Y4MReader(str(path)))) == 2
        # by file size, not by seek: the cut frame is not in the index
        assert len(io_native.y4m_frame_offsets(str(path), fmt.frame_bytes())) == 2
        assert (io_native.y4m_frame_offsets(str(path), fmt.frame_bytes())
                == jio.y4m_frame_offsets(str(path), fmt.frame_bytes()))


class TestAgainstJax:
    @pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
    @pytest.mark.parametrize("bits", [8, 10])
    def test_y4m_files_byte_identical_both_ways(self, tmp_path, subsampling, bits):
        frames = _frames(2, 32, 24, bits, subsampling, seed=bits)
        jframes = [jengine.Frame(y=f.y, u=f.u, v=f.v) for f in frames]
        args = (32, 24, bits, subsampling, 30, 1)
        a, b = tmp_path / "port.y4m", tmp_path / "jax.y4m"
        _write(video, a, args, frames)
        _write(jvideo, b, args, jframes)
        assert a.read_bytes() == b.read_bytes()
        # the port's file through raisr_tpu's reader, and the other way round
        jr, tr = jvideo.Y4MReader(str(a)), video.Y4MReader(str(b))
        assert jr.fmt.__dict__ == tr.fmt.__dict__
        for got, got_j, want in zip(tr, jr, frames):
            assert _planes_equal(got, want) and _planes_equal(got_j, want)

    @pytest.mark.parametrize("subsampling", ["420", "422", "444", "nv12", "mono"])
    @pytest.mark.parametrize("bits", [8, 10])
    def test_raw_files_byte_identical_both_ways(self, tmp_path, subsampling, bits):
        frames = _frames(2, 32, 24, bits, subsampling, seed=3)
        jframes = [jengine.Frame(y=f.y, u=f.u, v=f.v) for f in frames]
        args = (32, 24, bits, subsampling)
        a, b = tmp_path / "port.yuv", tmp_path / "jax.yuv"
        fmt = _write(video, a, args, frames, raw=True)
        _write(jvideo, b, args, jframes, raw=True)
        assert a.read_bytes() == b.read_bytes()
        assert a.stat().st_size == 2 * fmt.frame_bytes()
        got = list(video.RawYUVReader(str(b), fmt))
        got_j = list(jvideo.RawYUVReader(str(a), jvideo.VideoFormat(*args)))
        assert len(got) == len(got_j) == 2
        for g, gj, want in zip(got, got_j, frames):
            assert _planes_equal(g, want) and _planes_equal(gj, want)

    def test_reads_a_clip_written_by_neither(self, tmp_path):
        path = tmp_path / "clip.y4m"
        want = write_y4m_clip(str(path), 3, 24, 32, seed=2, bits=10, subsampling="422")
        for mod in (video, jvideo):
            rd = mod.Y4MReader(str(path))
            assert (rd.fmt.bits, rd.fmt.subsampling, rd.fmt.fps_num) == (10, "422", 25)
            for got, (y, u, v) in zip(rd, want):
                assert np.array_equal(got.y, y) and np.array_equal(got.u, u)
                assert np.array_equal(got.v, v)

    def test_format_properties(self):
        for args in ((32, 24, 8, "420"), (32, 24, 10, "422"), (32, 24, 16, "444"),
                     (32, 24, 8, "nv12"), (32, 24, 8, "mono")):
            a, b = video.VideoFormat(*args), jvideo.VideoFormat(*args)
            assert a.plane_shapes() == b.plane_shapes()
            assert a.frame_bytes() == b.frame_bytes()
            assert a.bytes_per_sample == b.bytes_per_sample and a.dtype == b.dtype

    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_io_native_equal(self, dtype):
        rng = np.random.default_rng(0)
        uv = rng.integers(0, 255, size=(6, 16)).astype(dtype)
        u, v = io_native.nv12_to_planar(uv)
        ju, jv = jio.nv12_to_planar(uv)
        assert np.array_equal(u, ju) and np.array_equal(v, jv)
        assert np.array_equal(u, uv[:, 0::2]) and np.array_equal(v, uv[:, 1::2])
        assert np.array_equal(io_native.planar_to_nv12(u, v), uv)
        assert np.array_equal(jio.planar_to_nv12(u, v), uv)
        a = rng.integers(0, 255, (9, 7)).astype(dtype)
        b = rng.integers(0, 255, (9, 7)).astype(dtype)
        assert io_native.plane_mse(a, b) == pytest.approx(jio.plane_mse(a, b), rel=1e-12)

    def test_metrics_equal(self):
        rng = np.random.default_rng(1)
        a = rng.integers(0, 255, (40, 48)).astype(np.float64)
        b = np.clip(a + rng.normal(0, 4, a.shape), 0, 255)
        assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
        assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
        assert metrics.psnr(a, a) == float("inf")
        assert metrics.ssim(a, a, 255.0) == pytest.approx(1.0, abs=1e-9)
        hi = a * 4
        assert metrics.psnr(hi, hi + 1) == jmetrics.psnr(hi, hi + 1)  # peak 1023 guessed


class TestNativeIO:
    def test_raw_nv12_reader_writer(self, tmp_path):
        h, w = 8, 12
        fmt = video.VideoFormat(w, h, 8, "nv12")
        frame = _frames(1, w, h, 8, "nv12", seed=1)[0]
        path = tmp_path / "clip.yuv"
        wr = video.RawYUVWriter(str(path), fmt)
        wr.write(frame)
        wr.close()
        assert path.stat().st_size == h * w * 3 // 2
        raw = np.frombuffer(path.read_bytes(), np.uint8)
        assert np.array_equal(raw[h * w:][0::2], frame.u.reshape(-1))  # U, V interleaved
        got = next(iter(video.RawYUVReader(str(path), fmt)))
        assert _planes_equal(got, frame)

    def test_offsets(self, tmp_path):
        path = tmp_path / "c.y4m"
        fmt = _write(video, path, (16, 8, 8, "420"), _frames(3, 16, 8, 8, "420", seed=2))
        offsets = io_native.y4m_frame_offsets(str(path), fmt.frame_bytes())
        assert len(offsets) == 3
        frames = list(video.Y4MReader(str(path)))
        with open(path, "rb") as f:
            f.seek(offsets[1])
            data = np.frombuffer(f.read(fmt.frame_bytes()), np.uint8)
        assert np.array_equal(data[: 16 * 8].reshape(8, 16), frames[1].y)

    def test_offsets_corrupt_marker(self, tmp_path):
        p = tmp_path / "bad.y4m"
        p.write_bytes(b"YUV4MPEG2 W4 H2 C420\nFRAMX\n" + bytes(12))
        if not io_native.HAVE_NATIVE:
            with pytest.raises(ValueError, match="FRAME"):
                io_native.y4m_frame_offsets(str(p), 12)

    def test_plane_mse(self):
        a = np.array([[1, 2], [3, 4]], np.uint8)
        b = np.array([[1, 4], [3, 1]], np.uint8)
        assert abs(io_native.plane_mse(a, b) - (0 + 4 + 0 + 9) / 4) < 1e-12

    def test_native_switch_is_the_ports_own(self):
        """The port's switch reads its own extension, never raisr_tpu's."""
        assert isinstance(io_native.HAVE_NATIVE, bool)
        assert io_native.HAVE_NATIVE == (io_native._raisrio is not None)
        if io_native.HAVE_NATIVE:
            assert io_native._raisrio.__name__ == "raisr_tpu_torch._raisrio"


class TestOpen:
    def test_open_by_extension(self, tmp_path):
        fmt = video.VideoFormat(16, 8, 8, "420")
        for name, wcls, rcls in (("a.y4m", video.Y4MWriter, video.Y4MReader),
                                 ("a.yuv", video.RawYUVWriter, video.RawYUVReader),
                                 ("a.raw", video.RawYUVWriter, video.RawYUVReader)):
            path = str(tmp_path / name)
            wr = video.open_writer(path, fmt)
            assert isinstance(wr, wcls)
            wr.write(_frames(1, 16, 8, 8, "420")[0])
            wr.close()
            rd = video.open_reader(path, fmt)
            assert isinstance(rd, rcls) and len(list(rd)) == 1
            rd.close()

    def test_open_refusals(self, tmp_path):
        fmt = video.VideoFormat(16, 8)
        with pytest.raises(RaisrError, match="unsupported input"):
            video.open_reader(str(tmp_path / "a.mp4"))
        with pytest.raises(RaisrError, match="unsupported output"):
            video.open_writer(str(tmp_path / "a.mkv"), fmt)
        with pytest.raises(RaisrError, match="--size"):
            video.open_reader(str(tmp_path / "a.yuv"))
        with pytest.raises(RaisrError, match="unsupported Y4M output"):
            video.Y4MWriter(io.BytesIO(), video.VideoFormat(16, 8, 8, "nv12"))

    def test_png_roundtrip(self, tmp_path):
        pytest.importorskip("PIL")
        from PIL import Image

        rng = np.random.default_rng(2)
        src = tmp_path / "in.png"
        rgb = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(src)
        frame = video.read_png_as_yuv(str(src), 8)
        jframe = jvideo.read_png_as_yuv(str(src), 8)
        assert _planes_equal(frame, jframe) and frame.y.shape == frame.u.shape == (24, 32)
        dst = tmp_path / "out.png"
        video.write_yuv_as_png(frame, str(dst), 8)
        back = np.asarray(Image.open(dst).convert("RGB")).astype(int)
        assert np.abs(back - rgb).max() <= 2  # one 8-bit YUV round trip
