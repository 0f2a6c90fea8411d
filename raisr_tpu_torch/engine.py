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
from raisr_tpu_torch.ops.cuda.upscale import pack_planes, unpack_planes
from raisr_tpu_torch.ops.pipeline import (
    pass_banks,
    pass_statics,
    process_plane_y,
    process_plane_y_batch,
    process_plane_uv,
)
from raisr_tpu_torch.parallel.sharding import (
    Mesh,
    process_batch_2d,
    process_batch_dp,
    process_plane_row_sharded,
    stripe_problem,
)
from raisr_tpu_torch.utils.profiler import span


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


def resolve_device(device: torch.device | str) -> torch.device:
    """The torch device an entry point runs on: a CUDA device gets its index
    (the current card when none is named); without a card a CUDA device is
    refused with a RaisrError, never replaced by the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RaisrError("device cuda requested but CUDA is not available.")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


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
    """Parse a "data=N[,rows=M]" shard spec (the `--shard` CLI knob).

    data: frames split over devices (the reference's N-parallel-streams
    throughput recipe, docs/performance.md:8, as one batch). rows: each
    frame's rows split over devices, halo copied between them: single-stream
    latency. Multiplied together they use data*rows devices."""
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
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model if model is not None else load_model(cfg.filterfolder, cfg)
        self._shard = shard if isinstance(shard, dict) else parse_shard_spec(shard)
        self._mesh = None
        n_dev = self._shard["data"] * self._shard["rows"]
        if n_dev > 1:
            if cfg.resize_mode != "bilinear":
                # the row-stripe halo resize and the DP stacked path are
                # built on the bilinear support/weight structure only
                raise RaisrError(
                    "sharding supports resize_mode=bilinear "
                    f"only (got {cfg.resize_mode})."
                )
            self._mesh = Mesh(
                np.array(self._mesh_devices(n_dev), dtype=object).reshape(
                    self._shard["data"], self._shard["rows"]),
                ("data", "rows"),
            )
        self._backend = _resolve_backend(cfg, self.device)
        if self.device.type == "cuda" and self._backend == "pallas":
            check_cuda_bank(self.model)
        self._statics = pass_statics(cfg, self.model, self._backend)
        self._np_out_dtype = np.uint8 if cfg.bits == 8 else np.uint16
        self._out_dtype = torch.uint8 if cfg.bits == 8 else torch.uint16
        # the passes are prepared once, here (phase-0 rows, the tier's bank
        # and its extras, the fused pass's checks and launch arguments), on
        # the engine's device and on each mesh device, each device's
        # preparation one span `raisr.banks`
        devices = [self.device] + (self._mesh.distinct() if self._mesh else [])
        self._banks = {}
        for d in dict.fromkeys(devices):
            with span("raisr.banks"):
                self._banks[d] = pass_banks(self._statics, bank_tensors(self.model, d)[0])
        self._filters = self._banks[self.device]

    def _mesh_devices(self, n: int) -> list[torch.device]:
        """The devices of an n-device mesh, as raisr_tpu takes the first n of
        jax.devices(): the first n visible cards for a CUDA engine, n entries
        of the CPU device for a CPU engine (the counterpart of the virtual
        CPU mesh)."""
        if self.device.type != "cuda":
            return [self.device] * n
        count = torch.cuda.device_count()
        if n > count:
            raise RaisrError(
                f"shard spec {self._shard} needs {n} "
                f"devices but only {count} are visible."
            )
        return [torch.device("cuda", i) for i in range(n)]

    def _check_rows_shardable(self, h: int, out_h: int):
        rows = self._shard["rows"]
        problem = stripe_problem(self._statics, self.cfg.passes, self.cfg.two_pass_mode,
                                 h, out_h, rows)
        if problem:
            raise RaisrError(
                f"rows={rows} cannot stripe input height {h} (output {out_h}): {problem}."
            )

    # -- single-plane entry points (device tensors in/out) -------------------

    def upscale_y(self, y: torch.Tensor) -> torch.Tensor:
        """Process one luma plane; accepts/returns integer-valued tensors."""
        h, w = y.shape
        out_h, out_w = self.cfg.output_size(h, w)
        if self._mesh is not None and self._shard["rows"] > 1:
            self._check_rows_shardable(h, out_h)
            return process_plane_row_sharded(
                y, self._banks, self._statics, self.cfg.passes,
                self.cfg.two_pass_mode, out_h, out_w, self._mesh, "rows",
            )
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
        with span("raisr.frame"):
            with span("raisr.frame.put"):
                y, u, v = (self._put(p) if p is not None else None
                           for p in (frame.y, frame.u, frame.v))
            y = self.upscale_y(y)
            u = self.upscale_uv(u) if u is not None else None
            v = self.upscale_uv(v) if v is not None else None
            with span("raisr.frame.get"):
                y, u, v = (p.cpu().numpy().astype(self._np_out_dtype) if p is not None
                           else None for p in (y, u, v))
        return Frame(y=y, u=u, v=v)

    def process_batch_y(self, batch_y: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Batched luma processing ([N, H, W] in, [N, oH, oW] `out_dtype`
        out: float32, or uint8 / uint16 packed as pack_planes packs).

        On the fused backend the batch rides ONE kernel launch per pass as a
        guard-banded vertical stack with per-frame zone masks; the output is
        exactly N x upscale_y. The frames are integer values, packed (uint8,
        uint16) or float32; row stripes take float32. Packed frames come
        from the last pass itself on the stack (process_plane_y_batch), from
        pack_planes on a mesh.

        With a shard spec (engine shard= / CLI --shard) the batch is spread
        over the mesh: frames over the data axis (each device runs the
        guard-banded stack on its own frames) and/or each frame's rows over
        the rows axis (halo copied between devices). Input and output stay
        on the engine's device."""
        n, h, w = batch_y.shape
        out_h, out_w = self.cfg.output_size(h, w)
        if self._mesh is None:
            return process_plane_y_batch(
                batch_y,
                self._filters,
                self._statics,
                self.cfg.passes,
                self.cfg.two_pass_mode,
                out_h,
                out_w,
                out_dtype,
            )
        d = self._shard["data"]
        if n % d:
            raise RaisrError(
                f"batch size {n} must be divisible by "
                f"the data shard count {d}."
            )
        if self._shard["rows"] > 1:
            self._check_rows_shardable(h, out_h)
            y = process_batch_2d(
                batch_y, self._banks, self._statics, self.cfg.passes,
                self.cfg.two_pass_mode, out_h, out_w, self._mesh, "data", "rows",
            )
        else:
            y = process_batch_dp(
                batch_y, self._banks, self._statics, self.cfg.passes,
                self.cfg.two_pass_mode, out_h, out_w, self._mesh, "data",
            )
        if out_dtype == torch.float32:
            return y
        with span("raisr.pack"):
            return pack_planes(y, out_dtype)

    def process_batch_uv(self, batch_uv: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Batched chroma cheap upscale ([N, H, W] in, `out_dtype` out)."""
        n, h, w = batch_uv.shape
        out_h, out_w = self.cfg.output_size(h, w)
        return process_plane_uv(batch_uv, out_h, out_w, self.cfg.bits,
                                self.cfg.resize_mode, out_dtype)

    def process_batch_device(
        self,
        batch_y: torch.Tensor,
        batch_u: torch.Tensor | None = None,
        batch_v: torch.Tensor | None = None,
    ):
        """Device-resident serving step: packed integer planes in, packed
        integer planes out, all on the engine's device.

        Runs the RAISR passes on Y and the cheap upscale on U/V, and packs to
        uint8 (bits=8) or uint16 (10/16), with no host synchronisation: no
        `.item()`, no copy to the host, no branch on tensor values. That is
        what lets a caller capture the step in a CUDA graph, the analogue of
        raisr_tpu's one-jit step under jax.transfer_guard("disallow")
        (tests/test_stream.py:56-93).

        The packed frames go to process_batch_y as they are (row stripes
        take them unpacked to float32): on the stacked route one glue launch
        (ops/cuda/upscale.py) unpacks, guard-bands and upscales them into
        pass 1's input, the last pass's launch B writes the packed Y frames
        (no pack of Y runs), and U and V take one launch each, packed in and
        packed out, so a 2x step's glue is three launches. A mesh and the
        per-frame loop pack Y with pack_planes.

        Under a torch.profiler the step is the span `raisr.step`, holding
        `raisr.glue` and `raisr.pass` (ops/pipeline.py), `raisr.pack` where
        Y is packed with pack_planes, and `raisr.chroma` (U and V).

        Y is [N, H, W]; U/V are optional [N, Hc, Wc] chroma batches."""
        with span("raisr.step"):
            for name, t in (("y", batch_y), ("u", batch_u), ("v", batch_v)):
                if t is not None and t.device != self.device:
                    raise RaisrError(
                        f"batch_{name} is on {t.device}, the engine on {self.device}."
                    )
            dtype = self._out_dtype
            y = batch_y if self._shard["rows"] == 1 else unpack_planes(batch_y)
            out_y = self.process_batch_y(y, dtype)
            with span("raisr.chroma"):
                out_u = self.process_batch_uv(batch_u, dtype) if batch_u is not None else None
                out_v = self.process_batch_uv(batch_v, dtype) if batch_v is not None else None
        return out_y, out_u, out_v
