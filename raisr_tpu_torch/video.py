"""Video / image I/O: Y4M, raw YUV, PNG.

Port of raisr_tpu/video.py (numpy only; PIL is imported inside the two PNG
functions, so clips need no PIL). Replaces the reference's FFmpeg-plugin I/O surface (reference:
ffmpeg/vf_raisr.c pixfmts yuv420p/yuv422p/yuv444p x 8/10-bit LE, :158-162)
with self-contained readers/writers so the CLI covers the validation-suite
scenarios without an FFmpeg build.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from typing import Iterator, Optional, BinaryIO

import numpy as np

from raisr_tpu_torch.config import RaisrError
from raisr_tpu_torch.engine import Frame


_SUBSAMPLING = {
    "420": (2, 2),
    "422": (1, 2),
    "444": (1, 1),
    "nv12": (2, 2),  # 4:2:0 with interleaved UV (vf_raisr_opencl sw format)
    "mono": None,
}


@dataclasses.dataclass
class VideoFormat:
    width: int
    height: int
    bits: int = 8
    subsampling: str = "420"  # 420 | 422 | 444 | mono
    fps_num: int = 25
    fps_den: int = 1

    @property
    def bytes_per_sample(self) -> int:
        return 1 if self.bits == 8 else 2

    @property
    def dtype(self):
        return np.uint8 if self.bits == 8 else np.dtype("<u2")

    def plane_shapes(self):
        y = (self.height, self.width)
        if self.subsampling == "mono":
            return y, None, None
        sv, sh = _SUBSAMPLING[self.subsampling]
        uv = (self.height // sv, self.width // sh)
        return y, uv, uv

    def frame_bytes(self) -> int:
        y, u, v = self.plane_shapes()
        total = y[0] * y[1]
        if u is not None:
            total += 2 * u[0] * u[1]
        return total * self.bytes_per_sample

    def scaled(self, out_h: int, out_w: int) -> "VideoFormat":
        return dataclasses.replace(self, width=out_w, height=out_h)


def _parse_y4m_colorspace(tag: str) -> tuple[str, int]:
    """C-tag -> (subsampling, bits). e.g. 420jpeg/420mpeg2/420paldv -> 420/8,
    420p10 -> 420/10, mono -> mono/8."""
    if tag.startswith("mono"):
        # FFmpeg's yuv4mpeg (de)muxer spells high-bit mono without the 'p'
        # (Cmono10/Cmono16); accept both spellings
        m = re.match(r"mono(?:p?(\d+))?$", tag)
        if not m:
            raise RaisrError(f"unsupported Y4M colorspace: C{tag}")
        bits = int(m.group(1)) if m.group(1) else 8
        if bits not in (8, 10, 12, 16):
            raise RaisrError(f"unsupported Y4M bit depth: C{tag}")
        return "mono", bits
    m = re.match(r"(420|422|444)(jpeg|mpeg2|paldv)?(p(\d+))?$", tag)
    if not m:
        raise RaisrError(f"unsupported Y4M colorspace: C{tag}")
    bits = int(m.group(4)) if m.group(4) else 8
    if bits not in (8, 10, 12, 16):
        raise RaisrError(f"unsupported Y4M bit depth: C{tag}")
    return m.group(1), bits


class Y4MReader:
    def __init__(self, f: BinaryIO | str):
        self._own = isinstance(f, (str, os.PathLike))
        self.f = open(f, "rb") if self._own else f
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise RaisrError("not a Y4M stream")
        w = h = None
        fps_num, fps_den = 25, 1
        subsampling, bits = "420", 8
        for tok in header.split()[1:]:
            key, val = tok[0], tok[1:]
            if key == "W":
                w = int(val)
            elif key == "H":
                h = int(val)
            elif key == "F":
                fps_num, fps_den = (int(x) for x in val.split(":"))
            elif key == "C":
                subsampling, bits = _parse_y4m_colorspace(val)
        if w is None or h is None:
            raise RaisrError("Y4M header missing W/H")
        self.fmt = VideoFormat(w, h, bits, subsampling, fps_num, fps_den)

    def __iter__(self) -> Iterator[Frame]:
        fmt = self.fmt
        y_shape, u_shape, v_shape = fmt.plane_shapes()
        dt = fmt.dtype
        while True:
            line = self.f.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise RaisrError("corrupt Y4M: missing FRAME marker")
            raw = self.f.read(fmt.frame_bytes())
            if len(raw) < fmt.frame_bytes():
                return
            buf = np.frombuffer(raw, dt)
            n_y = y_shape[0] * y_shape[1]
            y = buf[:n_y].reshape(y_shape)
            u = v = None
            if u_shape is not None:
                n_uv = u_shape[0] * u_shape[1]
                u = buf[n_y : n_y + n_uv].reshape(u_shape)
                v = buf[n_y + n_uv : n_y + 2 * n_uv].reshape(v_shape)
            yield Frame(y=y, u=u, v=v)

    def close(self):
        if self._own:
            self.f.close()


class Y4MWriter:
    def __init__(self, f: BinaryIO | str, fmt: VideoFormat):
        self._own = isinstance(f, (str, os.PathLike))
        self.f = open(f, "wb") if self._own else f
        self.fmt = fmt
        ctag = {
            ("420", 8): "420jpeg",
            ("422", 8): "422",
            ("444", 8): "444",
            ("mono", 8): "mono",
            ("420", 10): "420p10",
            ("422", 10): "422p10",
            ("444", 10): "444p10",
            ("420", 16): "420p16",
            ("422", 16): "422p16",
            ("444", 16): "444p16",
            # FFmpeg interop: its yuv4mpeg muxer tags these Cmono10/Cmono16
            ("mono", 10): "mono10",
            ("mono", 16): "mono16",
        }.get((fmt.subsampling, fmt.bits))
        if ctag is None:
            raise RaisrError(
                f"unsupported Y4M output format: {fmt.subsampling}/{fmt.bits}bit"
            )
        self.f.write(
            f"YUV4MPEG2 W{fmt.width} H{fmt.height} "
            f"F{fmt.fps_num}:{fmt.fps_den} Ip A1:1 C{ctag}\n".encode()
        )

    def write(self, frame: Frame):
        self.f.write(b"FRAME\n")
        dt = self.fmt.dtype
        self.f.write(np.ascontiguousarray(frame.y, dtype=dt).tobytes())
        if frame.u is not None:
            self.f.write(np.ascontiguousarray(frame.u, dtype=dt).tobytes())
            self.f.write(np.ascontiguousarray(frame.v, dtype=dt).tobytes())

    def close(self):
        if self._own:
            self.f.close()


class RawYUVReader:
    """Headerless planar YUV or NV12/P010 (format must be supplied)."""

    def __init__(self, f: BinaryIO | str, fmt: VideoFormat):
        self._own = isinstance(f, (str, os.PathLike))
        self.f = open(f, "rb") if self._own else f
        self.fmt = fmt

    def __iter__(self) -> Iterator[Frame]:
        fmt = self.fmt
        y_shape, u_shape, v_shape = fmt.plane_shapes()
        dt = fmt.dtype
        while True:
            raw = self.f.read(fmt.frame_bytes())
            if len(raw) < fmt.frame_bytes():
                return
            buf = np.frombuffer(raw, dt)
            n_y = y_shape[0] * y_shape[1]
            y = buf[:n_y].reshape(y_shape)
            u = v = None
            if u_shape is not None:
                n_uv = u_shape[0] * u_shape[1]
                if fmt.subsampling == "nv12":
                    from raisr_tpu_torch.io_native import nv12_to_planar

                    uv = buf[n_y : n_y + 2 * n_uv].reshape(
                        u_shape[0], 2 * u_shape[1]
                    )
                    u, v = nv12_to_planar(uv)
                else:
                    u = buf[n_y : n_y + n_uv].reshape(u_shape)
                    v = buf[n_y + n_uv : n_y + 2 * n_uv].reshape(v_shape)
            yield Frame(y=y, u=u, v=v)

    def close(self):
        if self._own:
            self.f.close()


class RawYUVWriter:
    def __init__(self, f: BinaryIO | str, fmt: VideoFormat):
        self._own = isinstance(f, (str, os.PathLike))
        self.f = open(f, "wb") if self._own else f
        self.fmt = fmt

    def write(self, frame: Frame):
        dt = self.fmt.dtype
        self.f.write(np.ascontiguousarray(frame.y, dtype=dt).tobytes())
        if frame.u is not None:
            if self.fmt.subsampling == "nv12":
                from raisr_tpu_torch.io_native import planar_to_nv12

                uv = planar_to_nv12(
                    np.ascontiguousarray(frame.u, dtype=dt),
                    np.ascontiguousarray(frame.v, dtype=dt),
                )
                self.f.write(uv.tobytes())
            else:
                self.f.write(np.ascontiguousarray(frame.u, dtype=dt).tobytes())
                self.f.write(np.ascontiguousarray(frame.v, dtype=dt).tobytes())

    def close(self):
        if self._own:
            self.f.close()


# -- still images ------------------------------------------------------------

BT601_TO_YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ]
)


def read_png_as_yuv(path: str, bits: int = 8) -> Frame:
    """PNG -> full-range YUV444 Frame (BT.601 matrix, like the classic RAISR
    single-image flow)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB")).astype(np.float64) / 255.0
    yuv = img @ BT601_TO_YUV.T
    max_val = (1 << bits) - 1
    y = np.clip(np.round(yuv[..., 0] * max_val), 0, max_val)
    u = np.clip(np.round((yuv[..., 1] + 0.5) * max_val), 0, max_val)
    v = np.clip(np.round((yuv[..., 2] + 0.5) * max_val), 0, max_val)
    dt = np.uint8 if bits == 8 else np.uint16
    return Frame(y=y.astype(dt), u=u.astype(dt), v=v.astype(dt))


def write_yuv_as_png(frame: Frame, path: str, bits: int = 8):
    from PIL import Image

    max_val = float((1 << bits) - 1)
    y = frame.y.astype(np.float64) / max_val
    if frame.u is not None and frame.u.shape == frame.y.shape:
        u = frame.u.astype(np.float64) / max_val - 0.5
        v = frame.v.astype(np.float64) / max_val - 0.5
    else:
        u = v = np.zeros_like(y)
    inv = np.linalg.inv(BT601_TO_YUV)
    rgb = np.stack([y, u, v], -1) @ inv.T
    rgb = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(rgb).save(path)


def open_reader(path: str, fmt: Optional[VideoFormat] = None):
    """Open a clip for reading. "-" reads a Y4M stream from stdin (raw YUV
    on stdin works too when fmt is given) — so the CLI composes in ffmpeg
    pipelines the way the reference's filter lives inside ffmpeg:
    `ffmpeg ... -f yuv4mpegpipe - | raisr-torch upscale -i - -o - | ffmpeg -i - ...`
    """
    if path == "-":
        import sys

        stdin = sys.stdin.buffer
        return RawYUVReader(stdin, fmt) if fmt is not None else Y4MReader(stdin)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MReader(path)
    if ext in (".yuv", ".raw"):
        if fmt is None:
            raise RaisrError("raw YUV input requires --size/--bits/--format")
        return RawYUVReader(path, fmt)
    raise RaisrError(f"unsupported input container: {ext}")


def open_writer(path: str, fmt: VideoFormat):
    """Open a clip for writing. "-" writes Y4M to stdout (self-describing,
    so downstream tools can probe it)."""
    if path == "-":
        import sys

        return Y4MWriter(sys.stdout.buffer, fmt)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MWriter(path, fmt)
    if ext in (".yuv", ".raw"):
        return RawYUVWriter(path, fmt)
    raise RaisrError(f"unsupported output container: {ext}")
