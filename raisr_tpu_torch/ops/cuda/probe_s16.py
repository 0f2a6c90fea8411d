"""Integer matrix product int8 x int8 -> int32: the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the TPU probe kernel of tools/probe_s16.py (`_kernel`, run through
`pl.pallas_call`), which checks the integer matmul mode the int8 tier's
hi/lo pair rests on (s8 x s8 -> s32) at the probe's shape [864, 144] x
[144, 512] (`M, K, N`). The probe's other modes (s16 x s8, s16 x s16,
s32 x s8) are what the TPU's Mosaic compiler refused; on the card the int8
tier needs no matmul at all (its gather-dot multiplies int16 taps in int32,
csrc/full_kernel.cu), so only s8 x s8 is ported.

`s8_matmul` runs csrc/probe_s16.cu on CUDA tensors and the plain version,
the int64 product cast to int32, on CPU tensors. There is no fallback.
`LAUNCHES` counts the calls that went through the kernel.
"""

from __future__ import annotations

import torch

from raisr_tpu_torch.ops.cuda.filter_kernel import _device_and_stream

LAUNCHES = 0

M, K, N = 864, 144, 512  # the probe's shape (tools/probe_s16.py:41)


def s8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on any device: the exact int64 product of
    a [m, k] and b [k, n] (as broadcast products and a sum, which every
    device runs in int64), cast to int32."""
    prod = a.to(torch.int64).unsqueeze(2) * b.to(torch.int64).unsqueeze(0)
    return prod.sum(dim=1).to(torch.int32)


def s8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] int8 @ b [k, n] int8 -> [m, n] int32, exact: the CUDA kernel
    for CUDA tensors, s8_matmul_reference for CPU tensors."""
    if b.device != a.device:
        raise ValueError(f"s8_matmul takes a and b on one device, got {a.device} and {b.device}")
    if a.device.type == "cpu":
        return s8_matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"s8_matmul runs on cpu or cuda, not {a.device}")
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2
            or a.shape[1] != b.shape[0] or not a.is_contiguous() or not b.is_contiguous()):
        raise ValueError(
            f"s8_matmul takes contiguous int8 [m, k] and [k, n] tensors, got "
            f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}"
        )

    from raisr_tpu_torch.ops.cuda._build import load_library

    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    dev, stream = _device_and_stream(a)
    err = load_library().raisr_s8_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                         m, n, k, dev, stream)
    if err:
        raise RuntimeError(f"raisr_s8_matmul launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return c
