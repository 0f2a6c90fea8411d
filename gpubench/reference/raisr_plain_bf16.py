"""RAISR upscaling at the bfloat16 tier in plain PyTorch: the benchmark's
reference for a configuration whose `dtype` is "bfloat16" at 8 bits.

The tier differs from float32 in its bank only. Each pass's float32 bank is
rounded once to bfloat16 with error diffusion along each row: over taps
0..120 in order, q = bf16(f + carry) (round to nearest even), then carry =
(carry + f) - q, all in float32. The rounded taps are widened back to
float32, which is exact, and handed to `raisr_plain.Reference`, which runs
the passes in float32 as it does for the float32 tier.

Why the comparison is exact (limits 0): at 8 bits every patch value is an
integer in 0..255, which bfloat16 holds exactly, and each pass's output is
an integer again before the next pass reads it. A bf16 tap times such a
value, summed in float32 over the taps in the same order 0..120, is then
the float32 dot of the widened bank, sample for sample, on any device.

The rounding is a frozen copy of the program's bank preparation for this
tier, kept here so that no later change to the program can move the
yardstick. It imports nothing of the program, and runs on any device.

Departures from upstream's AVX512-FP16 kernels (vf_raisr's default
asm=avx512fp16), which this tier stands in for:
- upstream rounds the bank to IEEE half precision (11 significant bits),
  tap by tap with no error diffusion; this tier rounds to bfloat16 (8
  significant bits) and carries each tap's rounding error to the next;
- upstream computes the structure tensor in half precision and scales
  GTWG by 100 to keep it in fp16's range, then divides by 100; this tier
  hashes in float32 with no scaling, as the float32 tier does;
- upstream sums the 121-tap dot in half precision; this tier sums it in
  float32.
"""

from __future__ import annotations

import torch

from . import raisr_plain
from .raisr_plain import N_TAPS, compare  # noqa: F401  (compare: the harness's check)


def round_bf16_error_diffused(filters: torch.Tensor) -> torch.Tensor:
    """[rows, >= 121] float32 taps -> [rows, 121] bfloat16 taps, rounded
    with the error carried along each row (see the module's docstring)."""
    f = filters[:, :N_TAPS].to(torch.float32)
    out = torch.empty(f.shape, dtype=torch.bfloat16, device=f.device)
    carry = torch.zeros(f.shape[0], dtype=torch.float32, device=f.device)
    for k in range(N_TAPS):
        q = (f[:, k] + carry).to(torch.bfloat16)
        carry = (carry + f[:, k]) - q.to(torch.float32)
        out[:, k] = q
    return out


class Reference(raisr_plain.Reference):
    """`raisr_plain.Reference` over each pass's bank rounded to bfloat16
    and widened back to float32."""

    def __init__(self, cfg: dict, banks: torch.Tensor, qstr, qcoh):
        rounded = torch.stack([round_bf16_error_diffused(b).to(torch.float32) for b in banks])
        super().__init__(cfg, rounded, qstr, qcoh)
