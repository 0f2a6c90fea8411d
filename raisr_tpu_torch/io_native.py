"""Native I/O fast paths with pure-numpy fallbacks.

The C++ extension (_raisrio, raisr_tpu_torch/native/raisrio.cpp,
built by `python setup.py build_ext --inplace`) provides the
data-plane routines the reference gets from its FFmpeg/IPP glue: NV12/P010
interleaving (vf_raisr_opencl.c's sw formats), Y4M frame indexing, plane MSE.
Everything here works without the extension (numpy fallback) so the
framework has no hard native dependency.
"""

from __future__ import annotations

import os

import numpy as np

try:
    from raisr_tpu_torch import _raisrio  # type: ignore

    HAVE_NATIVE = True
except ImportError:  # pragma: no cover
    _raisrio = None
    HAVE_NATIVE = False


def nv12_to_planar(uv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[h, 2w] interleaved UV -> (U [h,w], V [h,w])."""
    h, w2 = uv.shape
    if HAVE_NATIVE:
        u_b, v_b = _raisrio.nv12_to_planar(
            np.ascontiguousarray(uv).tobytes(), uv.dtype.itemsize
        )
        u = np.frombuffer(u_b, uv.dtype).reshape(h, w2 // 2)
        v = np.frombuffer(v_b, uv.dtype).reshape(h, w2 // 2)
        return u, v
    return uv[:, 0::2].copy(), uv[:, 1::2].copy()


def planar_to_nv12(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    if HAVE_NATIVE:
        uv_b = _raisrio.planar_to_nv12(
            np.ascontiguousarray(u).tobytes(),
            np.ascontiguousarray(v).tobytes(),
            u.dtype.itemsize,
        )
        return np.frombuffer(uv_b, u.dtype).reshape(u.shape[0], u.shape[1] * 2)
    out = np.empty((u.shape[0], u.shape[1] * 2), u.dtype)
    out[:, 0::2] = u
    out[:, 1::2] = v
    return out


def y4m_frame_offsets(path: str, frame_bytes: int) -> list[int]:
    """Payload byte offsets of every complete frame in a Y4M file.

    A truncated final frame is excluded by checking each frame's end offset
    against the real file size (seek past EOF succeeds and tell() reports the
    target position, so seek+tell alone cannot detect truncation)."""
    file_size = os.path.getsize(path)
    if HAVE_NATIVE:
        return [
            pos
            for pos in _raisrio.y4m_scan(path, frame_bytes)
            if pos + frame_bytes <= file_size
        ]
    offsets = []
    with open(path, "rb") as f:
        f.readline()
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("corrupt Y4M: missing FRAME marker")
            pos = f.tell()
            if pos + frame_bytes > file_size:
                break
            f.seek(frame_bytes, 1)
            offsets.append(pos)
    return offsets


def plane_mse(a: np.ndarray, b: np.ndarray) -> float:
    if HAVE_NATIVE and a.dtype.itemsize in (1, 2) and a.dtype == b.dtype:
        return float(
            _raisrio.mse(
                np.ascontiguousarray(a).tobytes(),
                np.ascontiguousarray(b).tobytes(),
                a.dtype.itemsize,
            )
        )
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(d * d))
