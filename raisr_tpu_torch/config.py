"""Configuration for the RAISR TPU pipeline.

One immutable dataclass replaces the reference's file-scope global state
(reference: Library/Raisr_globals.h) and carries the same knobs as the
`vf_raisr` FFmpeg filter (reference: ffmpeg/vf_raisr.c:81-94) plus the
`RNLInit` arguments (reference: Library/Raisr.h:14-24).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class RaisrError(ValueError):
    """Raised for every condition the reference maps to an RNLERRORTYPE != None.

    The reference returns error codes + logs `[RAISR ERROR] ...` to stdout
    (e.g. Library/Raisr.cpp:194,266,1435); we raise with the same message text
    so the validation sweep's log-grep semantics are preserved.
    """

    def __init__(self, message: str):
        super().__init__(f"[RAISR ERROR] {message}")


class RaisrWarning(UserWarning):
    """Mirrors the reference's `[RAISR WARNING]` stdout prints."""


class BlendingMode(enum.IntEnum):
    """Census-transform blending mode (reference: Library/RaisrDefaults.h:30-34)."""

    RANDOMNESS = 1
    COUNT_OF_BITS_CHANGED = 2


class RangeType(enum.IntEnum):
    """Color range (reference: Library/RaisrDefaults.h:44-48)."""

    VIDEO = 0  # 8-bit: 16..235, 10-bit: 64..940 (Raisr_globals.h:24-27)
    FULL = 1  # 0..2^bits-1


class Backend(str, enum.Enum):
    """Compute backend for the hot path.

    The reference dispatches between AVX2/AVX512/AVX512FP16/OpenCL kernels
    (Raisr.cpp:1481-1528); we dispatch between an unfused jnp reference
    pipeline (ground truth, runs anywhere) and fused TPU paths.
    """

    REFERENCE = "reference"  # unfused jnp, exact scalar semantics, any device
    XLA = "xla"  # conv-based dense formulation, XLA-fused
    PALLAS = "pallas"  # fused Pallas TPU kernel
    AUTO = "auto"


# Pixel-value clamps (reference: Library/Raisr_globals.h:19-27).
MIN_FULL = 0
MAX8BIT_FULL = 0xFF
MAX10BIT_FULL = 0x3FF
MAX16BIT_FULL = 0xFFFF
MIN8BIT_VIDEO = 16
MAX8BIT_VIDEO = 235
MIN10BIT_VIDEO = 64
MAX10BIT_VIDEO = 940

# Census-transform window (reference: Library/Raisr_globals.h:33-36).
CT_WINDOW_SIZE = 3
CT_NUM_OF_PIXEL = CT_WINDOW_SIZE * CT_WINDOW_SIZE - 1  # 8
CT_MARGIN = CT_WINDOW_SIZE >> 1  # 1
HASHING_EXPAND = CT_MARGIN

DEFAULT_PATCH_SIZE = 11  # reference: Library/RaisrDefaults.h:57


@dataclasses.dataclass(frozen=True)
class RaisrConfig:
    """All user-facing knobs, with the vf_raisr defaults.

    Reference option surface: ffmpeg/vf_raisr.c:81-94.
    """

    filterfolder: str = "filters_2x/filters_lowres"
    ratio: float = 2.0
    bits: int = 8
    range: RangeType = RangeType.VIDEO
    blending: BlendingMode = BlendingMode.COUNT_OF_BITS_CHANGED
    passes: int = 1
    mode: int = 1  # two-pass mode: 1 = upscale in 1st pass, 2 = in 2nd pass
    evenoutput: bool = False
    backend: Backend = Backend.AUTO
    # Compute dtype for the fused path. float32 matches the AVX2/AVX512 paths;
    # bfloat16 is the TPU analogue of the AVX512FP16 path; int8 (8-bit
    # content only) runs the filter matmul as int8 hi/lo fixed-point pairs
    # on the MXU's double-rate int8 path — between bfloat16 and float32 in
    # quality (ops/pallas/full_kernel.py i8). "auto" mirrors the reference's
    # production behavior — RNLInit auto-selects the fastest ISA tier the
    # machine supports, FP16 first (Raisr.cpp:1492-1501) — and resolves to
    # the fastest tier that passes the BASELINE ground-truth quality bar
    # (dPSNR-vs-GT <= 0.05 dB, asserted in tests/test_reference_parity.py):
    # bfloat16 (8-bit: the bf16 fast tier; 10/16-bit: the p_split exact-patch
    # packing). The conservative default stays float32.
    dtype: str = "float32"
    # Replicate the reference hot loop's unroll-dependent ragged right edge
    # (processed cols end at 6 + 8*floor((W-12)/8), Raisr.cpp:1066,1247-1250)
    # exactly. False processes the full [6, W-6) range (cleaner, >= quality).
    exact_edges: bool = True
    # Cheap-upscale resampler. The reference compile-selects these
    # (USE_BICUBIC = IPP cubic B=0 C=0.75, USE_LANCZOS = 3-lobe,
    # Raisr_globals.h:63-81, Raisr.cpp:458-478); here it's a runtime knob.
    # bilinear is the reference default and the only mode with a fused
    # batched-stack / row-sharded formulation.
    resize_mode: str = "bilinear"

    def __post_init__(self):
        # Mirrors RNLInit's validation (Raisr.cpp:1429-1474).
        if self.passes not in (1, 2):
            raise RaisrError("Only support passes 1 or 2. ")
        if self.bits not in (8, 10, 16):
            raise RaisrError(f"bit depth: {self.bits}bits is NOT supported.")
        if self.blending not in (1, 2):
            raise RaisrError(f"blending mode: {self.blending} is NOT supported.")
        if self.mode not in (1, 2):
            raise RaisrError(f"two-pass mode: {self.mode} is NOT supported.")
        if not (1.0 < self.ratio <= 4.0):
            raise RaisrError(f"ratio: {self.ratio} is NOT supported.")
        if self.dtype == "auto":
            # reference parity: auto-select the production fast tier
            # (Raisr.cpp:1492-1501 picks AVX512FP16 when supported)
            object.__setattr__(self, "dtype", "bfloat16")
        if self.dtype not in ("float32", "bfloat16", "bfloat16_exact",
                              "int8"):
            raise RaisrError(f"dtype: {self.dtype} is NOT supported.")
        if self.dtype == "int8" and self.bits != 8:
            raise RaisrError("dtype int8 requires 8-bit content.")
        if self.resize_mode not in ("bilinear", "cubic", "lanczos"):
            raise RaisrError(
                f"resize mode: {self.resize_mode} is NOT supported."
            )
        if self.dtype == "int8" and self.ratio != 2.0:
            # the int8-pair matmul is implemented in the 4-phase (ratio-2)
            # kernel only; refuse rather than silently run another tier
            raise RaisrError("dtype int8 requires ratio 2 "
                             "(use bfloat16 for other ratios).")

    # --- Derived quantities -------------------------------------------------

    @property
    def min_val(self) -> int:
        """Lower clamp (reference: Raisr.cpp:1446-1469)."""
        if self.bits == 8:
            return MIN8BIT_VIDEO if self.range == RangeType.VIDEO else MIN_FULL
        if self.bits == 10:
            return MIN10BIT_VIDEO if self.range == RangeType.VIDEO else MIN_FULL
        return MIN_FULL  # 16-bit is always full range in the reference

    @property
    def max_val(self) -> int:
        if self.bits == 8:
            return MAX8BIT_VIDEO if self.range == RangeType.VIDEO else MAX8BIT_FULL
        if self.bits == 10:
            return MAX10BIT_VIDEO if self.range == RangeType.VIDEO else MAX10BIT_FULL
        return MAX16BIT_FULL

    @property
    def use_pixel_type(self) -> bool:
        """Per-pixel phase filter selection, only for integral 2x
        (reference: Raisr.cpp:1477-1480)."""
        return self.ratio == 2.0

    @property
    def two_pass_mode(self) -> int:
        """Which pass performs the cheap upscale (1-indexed).

        passes=1 + mode=2 is ignored with a warning in the reference
        (Raisr.cpp:1434-1435)."""
        return self.mode if self.passes == 2 else 1

    def output_size(self, h: int, w: int) -> tuple[int, int]:
        """Output plane dims (reference: ffmpeg/vf_raisr.c:208-224)."""
        oh, ow = int(h * self.ratio), int(w * self.ratio)
        if self.evenoutput:
            oh -= oh % 2
            ow -= ow % 2
        return oh, ow
