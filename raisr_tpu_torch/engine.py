"""RaisrEngine — the user-facing frame processor.

Port of raisr_tpu/engine.py. Replaces the reference's RNLInit / RNLSetRes /
RNLProcess / RNLDeinit lifecycle (reference: Library/Raisr.h:14-33) with an
object that loads the model once, puts the banks on its device, and processes
frames functionally. PyTorch runs eagerly, so there is no compile step; a
caller that wants one launch graph captures `process_batch_device` in a
`torch.cuda.CUDAGraph` (it makes no host synchronisation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raisr_tpu_torch.config import RaisrConfig, Backend, RaisrError
from raisr_tpu_torch.model.loader import load_model, RaisrModel, bank_tensors
from raisr_tpu_torch.ops.cuda.filter_kernel import check_bank_limits
from raisr_tpu_torch.ops.pipeline import (
    pass_banks,
    pass_statics,
    process_plane_y,
    process_plane_y_batch,
    process_plane_uv,
)


def unpack_planes(t: torch.Tensor) -> torch.Tensor:
    """Packed integer planes (uint8, uint16) -> float32, on their device.
    uint16 has few kernels on CUDA, so it is read through its int16 view (a
    reinterpretation, no copy) and widened in int32."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.float32)


def pack_planes(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer-valued float32 planes in [0, 2^bits) -> `dtype` (uint8 or
    uint16; uint16 written through int32 and an int16 view)."""
    if dtype == torch.uint16:
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def _resolve_backend(cfg: RaisrConfig, device: torch.device) -> str:
    """reference -> taps; xla -> conv (the dense-conv formulation, float32);
    pallas -> the fused pass (the CUDA kernel on a CUDA device, its plain
    version on the CPU); auto -> the fused kernel on CUDA and taps on the
    CPU."""
    if cfg.backend == Backend.REFERENCE:
        return "taps"
    if cfg.backend == Backend.XLA:
        return "conv"
    if cfg.backend == Backend.PALLAS:
        return "pallas"
    return "pallas" if device.type == "cuda" else "taps"


def check_cuda_bank(model: RaisrModel) -> None:
    """Refuses a bank the CUDA pass cannot hash (`check_bank_limits`: more
    than 256 buckets, or more than 8 strength or coherence edges) with a
    RaisrError that names the limit. The engine asks at construction, for the
    fused backend on a CUDA device, so no pass or graph capture meets the
    refusal later; the taps backend and the CPU take any bank."""
    for i, bank in enumerate(model.banks):
        try:
            check_bank_limits(model.qangle, model.qstrength, model.qcoherence,
                              len(bank.qstr), len(bank.qcoh))
        except ValueError as e:
            raise RaisrError(
                f"the fused backend on a CUDA device cannot serve the bank of pass "
                f"{i + 1}: {e}."
            ) from e


@dataclasses.dataclass
class Frame:
    """One video frame as planes (Y required; U/V optional for gray input).

    Arrays are uint8 (bits=8) or uint16 (bits=10/16), matching the
    VideoDataType buffers of the reference (Library/RaisrDefaults.h:10-16).
    """

    y: np.ndarray
    u: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None


def parse_shard_spec(spec: Optional[str]) -> dict:
    """Parse a "data=N[,rows=M]" shard spec (the `--shard` CLI knob)."""
    out = {"data": 1, "rows": 1}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if "=" not in part:
            raise RaisrError(f"[RAISR ERROR] bad --shard spec: {spec!r} "
                             "(expected data=N[,rows=M])")
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in out:
            raise RaisrError(f"[RAISR ERROR] unknown shard axis {k!r} "
                             "(use data / rows)")
        try:
            out[k] = int(v)
        except ValueError:
            raise RaisrError(f"[RAISR ERROR] bad shard count {v!r} for {k}")
        if out[k] < 1:
            raise RaisrError(f"[RAISR ERROR] shard count must be >= 1: {part}")
    return out


_banner_done = False


class RaisrEngine:
    def __init__(
        self,
        cfg: RaisrConfig,
        model: Optional[RaisrModel] = None,
        shard: Optional[str | dict] = None,
        device: torch.device | str = "cuda",
    ):
        # versioned init banner, once per process (the reference prints its
        # lib version at every RNLInit, Raisr.cpp:1418-1420)
        global _banner_done
        if not _banner_done:
            _banner_done = True
            import raisr_tpu_torch
            from raisr_tpu_torch.utils import logging as _rlog

            _rlog.banner(raisr_tpu_torch.__version__)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RaisrError("device cuda requested but CUDA is not available.")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.model = model if model is not None else load_model(cfg.filterfolder, cfg)
        self._shard = shard if isinstance(shard, dict) else parse_shard_spec(shard)
        if self._shard["data"] * self._shard["rows"] > 1:
            raise RaisrError(
                f"shard spec {self._shard} needs several devices; multi-device "
                "serving is not ported to raisr_tpu_torch yet (ROADMAP A13)."
            )
        self._backend = _resolve_backend(cfg, self.device)
        if self.device.type == "cuda" and self._backend == "pallas":
            check_cuda_bank(self.model)
        self._statics = pass_statics(cfg, self.model, self._backend)
        self._np_out_dtype = np.uint8 if cfg.bits == 8 else np.uint16
        self._out_dtype = torch.uint8 if cfg.bits == 8 else torch.uint16
        # the bin edges travel as floats in self._statics; the banks are
        # prepared for the pass once, here (phase-0 rows, the tier's bank
        # and its extras)
        self._filters = pass_banks(self._statics,
                                   bank_tensors(self.model, self.device)[0])

    # -- single-plane entry points (device tensors in/out) -------------------

    def upscale_y(self, y: torch.Tensor) -> torch.Tensor:
        """Process one luma plane; accepts/returns integer-valued tensors."""
        h, w = y.shape
        out_h, out_w = self.cfg.output_size(h, w)
        return process_plane_y(
            y,
            self._filters,
            self._statics,
            self.cfg.passes,
            self.cfg.two_pass_mode,
            out_h,
            out_w,
        )

    def upscale_uv(self, plane: torch.Tensor) -> torch.Tensor:
        h, w = plane.shape
        out_h, out_w = self.cfg.output_size(h, w)
        return process_plane_uv(plane, out_h, out_w, self.cfg.bits,
                                self.cfg.resize_mode)

    # -- frame API -----------------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

    def process(self, frame: Frame) -> Frame:
        """Upscale one frame (numpy in / numpy out)."""
        if frame.y is None:
            raise RaisrError("Y plane is required.")
        y = self.upscale_y(self._put(frame.y))
        u = self.upscale_uv(self._put(frame.u)) if frame.u is not None else None
        v = self.upscale_uv(self._put(frame.v)) if frame.v is not None else None
        to_np = lambda a: a.cpu().numpy().astype(self._np_out_dtype)
        return Frame(
            y=to_np(y),
            u=to_np(u) if u is not None else None,
            v=to_np(v) if v is not None else None,
        )

    def process_batch_y(self, batch_y: torch.Tensor) -> torch.Tensor:
        """Batched luma processing ([N, H, W] in, [N, oH, oW] out).

        On the fused backend the batch rides ONE kernel launch per pass as a
        guard-banded vertical stack with per-frame zone masks; the output is
        exactly N x upscale_y."""
        n, h, w = batch_y.shape
        out_h, out_w = self.cfg.output_size(h, w)
        return process_plane_y_batch(
            batch_y,
            self._filters,
            self._statics,
            self.cfg.passes,
            self.cfg.two_pass_mode,
            out_h,
            out_w,
        )

    def process_batch_uv(self, batch_uv: torch.Tensor) -> torch.Tensor:
        """Batched chroma cheap upscale ([N, H, W] in)."""
        n, h, w = batch_uv.shape
        out_h, out_w = self.cfg.output_size(h, w)
        return process_plane_uv(batch_uv, out_h, out_w, self.cfg.bits,
                                self.cfg.resize_mode)

    def process_batch_device(
        self,
        batch_y: torch.Tensor,
        batch_u: torch.Tensor | None = None,
        batch_v: torch.Tensor | None = None,
    ):
        """Device-resident serving step: packed integer planes in, packed
        integer planes out, all on the engine's device.

        Unpacks to float32, runs the RAISR passes on Y and the cheap upscale
        on U/V, and repacks to uint8 (bits=8) or uint16 (10/16), with no host
        synchronisation: no `.item()`, no copy to the host, no branch on
        tensor values. That is what lets a caller capture the step in a CUDA
        graph, the analogue of raisr_tpu's one-jit step under
        jax.transfer_guard("disallow") (tests/test_stream.py:56-93).

        Y is [N, H, W]; U/V are optional [N, Hc, Wc] chroma batches."""
        for name, t in (("y", batch_y), ("u", batch_u), ("v", batch_v)):
            if t is not None and t.device != self.device:
                raise RaisrError(
                    f"batch_{name} is on {t.device}, the engine on {self.device}."
                )
        dtype = self._out_dtype
        out_y = pack_planes(self.process_batch_y(unpack_planes(batch_y)), dtype)
        out_u = (
            pack_planes(self.process_batch_uv(unpack_planes(batch_u)), dtype)
            if batch_u is not None else None
        )
        out_v = (
            pack_planes(self.process_batch_uv(unpack_planes(batch_v)), dtype)
            if batch_v is not None else None
        )
        return out_y, out_u, out_v
