"""Python side of the C ABI (include/raisr_tpu.h, native/capi.cpp).

Port of raisr_tpu/capi_bridge.py, with the same names, signatures, return
codes and `[RAISR ERROR]` messages. The embedded-CPython library passes raw
buffer addresses and geometry; this module views them with ctypes and numpy
(no copy in, one copy out) and drives a module-level RaisrEngine: one engine
per process, as the header's handle-free functions imply (the reference's
global state, Raisr_globals.h).

The engine runs on the card unless the caller asks for the CPU: a Python
caller with `init(..., device="cpu")`, a C host (which has no other channel)
with the environment variable RAISR_TPU_TORCH_DEVICE=cpu. Without a card and
without that request `init` returns 1 with the engine's message; nothing
falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os

import numpy as np
import torch

from raisr_tpu_torch.config import RaisrConfig, BlendingMode, RangeType
from raisr_tpu_torch.engine import RaisrEngine, Frame

DEVICE_ENV = "RAISR_TPU_TORCH_DEVICE"
# RTPUTier -> RaisrConfig.dtype, as raisr_tpu's bridge maps it
_TIERS = {0: "float32", 1: "bfloat16", 2: "int8"}

_engine: RaisrEngine | None = None
_cfg: RaisrConfig | None = None
_device_index: int | None = None  # RTPU_SetDevice's card, used by the next init
# blending is a per-Process argument in the reference (RNLProcess); the
# engine of the other mode is built once, sharing the loaded model and its
# device, never per frame
_engines_by_blend: dict[int, RaisrEngine] = {}


def _requested_device() -> str:
    return os.environ.get(DEVICE_ENV) or "cuda"


def set_device(index: int) -> int:
    """Pin the engine of the next init to card `index` (RTPU_SetDevice, the
    analogue of RNLHandler_SetOpenCLContext's device selection, reference
    Library/RaisrHandler.h:42-46). The index is checked against
    torch.cuda.device_count(), or against 1 where the CPU was asked for.
    Sharded engines (engine shard=) place themselves."""
    global _device_index
    try:
        count = 1 if _requested_device() == "cpu" else torch.cuda.device_count()
        if not 0 <= index < count:
            print(f"[RAISR ERROR] device index {index} out of range "
                  f"(have {count})")
            return 1
        _device_index = index
        return 0
    except Exception as e:  # noqa: BLE001 — C boundary: report, don't raise
        print(f"[RAISR ERROR] set_device failed: {e}")
        return 3


def init(model_path: str, ratio: float, bit_depth: int, range_type: int,
         passes: int, two_pass_mode: int, tier: int = 0,
         device: str | None = None) -> int:
    """tier: 0 = f32-grade, 1 = bf16 fast tier, 2 = int8-pair fixed-point
    tier (8-bit content only) — the analogue of the reference C ABI's
    asmType parameter (RNLHandler_Init). `device` ("cuda", "cpu" or a
    torch device string) overrides RAISR_TPU_TORCH_DEVICE. On a CUDA device
    the kernel library is built or loaded here, so a failed build fails
    RTPU_Init and not the first frame."""
    global _engine, _cfg
    try:
        dev = torch.device(device or _requested_device())
        if dev.type == "cuda" and dev.index is None and _device_index is not None:
            dev = torch.device("cuda", _device_index)
        _cfg = RaisrConfig(
            filterfolder=model_path,
            ratio=ratio,
            bits=bit_depth,
            range=RangeType(range_type),
            passes=passes,
            mode=two_pass_mode,
            dtype=_TIERS.get(tier, "float32"),
        )
        _engine = RaisrEngine(_cfg, device=dev)
        if _engine.device.type == "cuda":
            from raisr_tpu_torch.ops.cuda import _build

            _build.load_library()
        _engines_by_blend.clear()
        _engines_by_blend[int(_cfg.blending)] = _engine
        return 0
    except Exception as e:  # noqa: BLE001
        _engine = _cfg = None
        print(str(e))
        return 1


def _view(addr: int, height: int, width: int, step: int, bits: int) -> np.ndarray:
    """The caller's strided plane as a [height, width] array (no copy):
    uint8 at 8 bits, little-endian uint16 above; `step` is the row stride
    in bytes."""
    itemsize = 1 if bits == 8 else 2
    if step < width * itemsize or step % itemsize:
        raise ValueError(f"plane step {step} does not hold {width} samples of "
                         f"{itemsize} byte(s)")
    buf = (ctypes.c_uint8 * (step * height)).from_address(addr)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(height, step)
    if itemsize == 1:
        return arr[:, :width]
    return arr.view("<u2")[:, :width]


def process(
    in_y, in_cb, in_cr, out_y, out_cb, out_cr, blending: int
) -> int:
    """Each plane arg: None or (addr, width, height, step)."""
    if _engine is None:
        print("[RAISR ERROR] RTPU_Process called before RTPU_Init")
        return 1
    try:
        bits = _cfg.bits

        def rd(p):
            if p is None:
                return None
            addr, w, h, step = p
            return _view(addr, h, w, step, bits)

        frame = Frame(y=rd(in_y), u=rd(in_cb), v=rd(in_cr))
        eng = _engines_by_blend.get(int(blending))
        if eng is None:
            eng = RaisrEngine(
                dataclasses.replace(_engine.cfg, blending=BlendingMode(blending)),
                model=_engine.model, device=_engine.device,
            )
            _engines_by_blend[int(blending)] = eng
        # a host thread whose current card is another still launches on
        # the engine's
        on_card = (torch.cuda.device(eng.device) if eng.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            result = eng.process(frame)

        def wr(p, plane):
            if p is None or plane is None:
                return
            addr, w, h, step = p
            dst = _view(addr, h, w, step, bits)
            np.copyto(dst, plane[:h, :w])

        wr(out_y, result.y)
        wr(out_cb, result.u)
        wr(out_cr, result.v)
        return 0
    except Exception as e:  # noqa: BLE001
        print(f"[RAISR ERROR] {e}")
        return 1


def deinit() -> int:
    global _engine, _cfg
    _engine = None
    _cfg = None
    _engines_by_blend.clear()
    return 0
