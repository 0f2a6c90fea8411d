#!/usr/bin/env python3
"""Smoke run of raisr_tpu_torch's serving paths on one NVIDIA card.

Usage, from the root of a checkout:

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile DIR    # and torch.profiler phases
    python3 chip_smoke.py --cards 4        # the multi-device paths over 4 cards

It builds the port's CUDA kernels from the checkout's sources, then, for the
2x path (the 4-phase kernel):
  1. holds the fused-pass kernel against its plain PyTorch version, bit for
     bit: on one 4K plane for both census blendings, and on the very planes
     the main path hands it (both passes over the 4-frame guard-banded stack);
  2. drives the main path once, RaisrEngine.process_batch_device on 4 frames
     of 8-bit YUV420 1080p -> 4K, 2 passes, CountOfBitsChanged, with a bank
     of the real shape made from a seed, and checks every frame against the
     plain passes, the port's taps engine and the chroma upscale, and that
     the glue ran as 3 launches of its kernel (csrc/upscale.cu: Y, U, V)
     and none of the PyTorch chain it replaces;
  3. captures that step in a CUDA graph and replays it;
  4. times the kernel against its plain version, and the serving step;
  5. with --profile DIR only: traces 10 serving steps with torch.profiler,
     writes the trace to DIR/step_trace.json and prints the device time per
     step by kernel and the device's busy share of the traced window.
and for the 1.5x path (the single-phase kernel):
  6. holds the single-phase kernel against its plain version, bit for bit: on
     one 1620x2880 plane for both blendings, and on the launch the 1.5x path
     makes (the 4-frame stack of 6552x2880, frame_h 1620, frame_pad 9);
  7. drives RaisrEngine.process_batch_device on the same 4 frames of 8-bit
     YUV420 1080p -> 1620x2880, 1 pass, CountOfBitsChanged, with a seeded
     216x1x121 bank, and checks every frame as phase 2 does;
  8. captures that step in a CUDA graph and replays it;
  9. times the single-phase kernel against its plain version, the 1.5x
     stacked resize and the 1.5x serving step; with --profile DIR it also
     traces 10 of those steps into DIR/step15_trace.json.
then the filter kernels, the bf16 tier and the 2.5x route:
 10. holds the filter apply (apply_filters: the gather launch over the
     caller's int32 buckets, 4 phases on pass 1's 8736x3840 stack with the
     plain hash's buckets and on a 4K plane with uniform buckets in
     [-8, 232); 1 phase on the 1.5x path's 6552x2880 stack) and launch A
     alone (apply_filters_hash, on the stack and on a 4K patchwork plane
     whose buckets spread over nearly all 216) against their plain versions,
     and the staged pass (apply_filters, then the plain epilogue) against
     the fused pass, bit for bit; expects apply_filters to refuse a bank
     that does not fit in shared memory; holds launch B alone
     (pass_epilogue) against the plain epilogue on the 4K plane, both
     stacks and a row stripe, for both blendings, and times it on the plane
     and the 2x stack beside its bound; holds and times its packed store
     (uint8 and uint16 frames, the batched step's last pass) on the 2x
     stack against float32 out then pack_planes; times the plain hash, apply_filters,
     apply_filters_hash and the fused pass on a smooth 4K plane, the
     patchwork plane and the stack, prints the device time of each kernel
     of one fused pass (launch A1 the hash, A2 the gather from the resident
     bank, B the epilogue) from a torch.profiler trace, and how many
     distinct bank rows and wavefronts A2's quarter-warps read on each 4K
     plane;
 11. the 8-bit bf16 tier (dtype="auto"): the bf16 kernel against its plain
     version on a 4K plane (both blendings) and a 1620x2880 plane (1 phase);
     both paths through process_batch_device, eager and as a replayed CUDA
     graph, every frame against the plain bf16 passes; prints the difference
     to the float32 frames and the step times beside the float32 ones; with
     --profile DIR it also traces 10 steps of each path into
     DIR/step_bf16_2x_trace.json and DIR/step_bf16_1.5x_trace.json;
 12. a 2x bank at 2.5x (one 1080p frame to 2700x4800, 1 pass): the
     single-phase kernel over the bank's phase-0 rows, against the plain pass
     and the taps engine.
then the remaining tiers and the integer probe (run_tier: each tier's kernel
against its plain version on one output-size plane and on the 4-frame stack,
bit for bit; the path through process_batch_device, every frame against the
plain passes, a replayed CUDA graph against eager, the tier's launch count;
the difference to the float32 frames and the times printed):
 13. the int8 tier: phase 2's frames and bank, dtype="int8";
 14. the >8-bit tiers on uint16 frames, 4 x 1080p: 10-bit 2x 2-pass float32,
     bfloat16 (pcenter) and bfloat16_exact (p_split); 16-bit 2x 1-pass
     float32 and bfloat16 (p_split); 10-bit 1.5x 1-pass float32 and bfloat16
     (the single-phase p_split);
 15. the s8 x s8 -> s32 matmul probe (tools/probe_s16.py) at [864, 144] x
     [144, 512], against the int64 product and torch._int_mm, each timed as
     a CUDA graph of 100 calls.
then the file-to-file serving path (a 2-pass 216x4x121 bank written to a
folder and loaded from it; 24 distinct 8-bit YUV420 1080p frames from a seed):
 16. StreamProcessor(depth 2, batch 4) over the frames in host memory: every
     frame equal to engine.process of it, bit for bit, also at batch 1 and on
     22 frames (a tail of 2); 2 fused launches a group; the first group
     against the plain passes; frames/s at depth 1, 2 and 4 beside phase 4's
     resident step, the Tracer's stages, and a group's copies and staging
     timed apart;
 17. the CLI in process: `raisr-torch upscale` of the frames as a Y4M file,
     the output read back (3840x2160, 24 frames, each equal to phase 16's),
     then `compare`, `info`, `bench --frames 20` and `bench --latency`;
 18. cheap_upscale in cubic and lanczos at 2x and 1.5x, the card against the
     CPU (max abs error 0); one frame through the fused engine with
     resize_mode="cubic" against the plain passes; backend="xla" (the dense
     convolution) against backend="reference" within the fuzz bar;
 19. two-pass mode 2 (run_tier): 4 frames 1080p, 2x, 2 passes, float32; pass
     1 over the 4416x1920 LR stack (guard 12), pass 2 over the 4K stack
     (guard 24), each launch and every frame against its plain version.
then filter training (run_train):
 20. `raisr-torch train` on a Y4M clip of 8 seeded 1080p HR frames with edges
     and texture (the 8th held out): 2x with 2 passes and --ct-refine
     (blending 2), then 1.5x with 1 pass; the launches of the normal-equation
     kernel (csrc/normal_eq.cu), apply_filters and launch B against what each
     run makes, and the hold-out PSNR of the trained bank and of bilinear;
     on one 1080p pair the kernel against its plain version accumulated in
     float64 (within 1e-4 of each filter's largest entry, plain and weighted),
     two runs bit for bit, the banks solved from both (rtol 2e-3, atol 2e-4);
     its time beside its bound, the plain version and the one-hot
     torch.matmul form of raisr_tpu's _accumulate_chunked (timed on 8 chunks,
     scaled); the trained 2x bank served from its folder, 4 frames through
     process_batch_device against the plain passes (bit for bit) and the taps
     engine, and the bf16 and int8 tiers beside float32 on it.
then the multi-device paths (run_shard), over meshes that name the card 2 or
4 times, so that each shard runs in turn on it with real halo copies:
 21. stripe launches of the fused pass (stripes 0 and 1 of 4 at 2x, stripe 1
     of 2 at 1.5x, from the striped resize) against the plain version, bit
     for bit; process_batch_2d (data 2 x rows 2), process_batch_dp (data 4)
     and process_plane_row_sharded (rows 4) on phase 2's frames, and rows 2
     at 1.5x, in mode 2, at dtype auto and int8, each against the earlier
     phase's unsharded output bit for bit with its launch counts; the
     engine's refusal of shard="data=2" on one visible card;
     train_step_sharded over data 4 on phase 20's 8 frames, plain and
     CT-weighted, against one-device training and itself; the sharded
     steps' device and host-enqueue times beside the unsharded step, at mesh
     sizes 1, 2 and 4.
then the C ABI (run_capi):
 22. builds build/capi_torch/libraisr_tpu.so (native/capi.cpp) and the C
     tools capi_smoke and capi_y4m from the checkout, and loads the library
     here with ctypes: RTPU_SetDevice(0), RTPU_InitEx at 2x, 8 bits, 2
     passes for tiers 0, 1 and 2 on a folder of phase 16's bank (seed 16),
     RTPU_SetRes and RTPU_Process over 4 frames of 1080p YUV420 in strided
     planes (rows 64 bytes longer than their samples, in and out), every
     output equal to engine.process at the tier bit for bit and nothing
     written past a row, the tier's fused launches exactly frames x passes;
     both blendings (the second's engine built once); one 10-bit 2x float32 frame and one 1.5x
     frame; RTPU_Process from a second host thread against the main
     thread's bytes; capi_y4m on a Y4M of 8 seeded 1080p frames against
     `raisr-torch upscale` of the same clip and folder, byte for byte, and
     capi_smoke; the error codes of a card index out of range, a missing
     folder and Process after Deinit; Init's time, ms per RTPU_Process
     beside engine.process and the batched step's per-frame share, and
     capi_y4m's frames/s beside the CLI's, on the host's clock. Its
     launches and errors are added to the rows of the kernels it ran.
then the validation sweep (run_sweep, raisr_tpu_torch.tools.validation_sweep):
 23. on the tool's seeded filter folders (2x lowres/highres/denoise at 8 and
     10 bits, 1.5x highres/denoise; 2 passes each), every positive row of
     the sweep through `raisr-torch upscale` with no --device, on 2 seeded
     1080p frames (8-bit, or 10-bit in [64, 940)): exit 0 without
     "[RAISR ERROR]", the output at the ratio (U and V too), every frame
     equal to RaisrEngine(cfg).process on the card bit for bit, only the
     fused form pass_statics names for the row and as many launches as its
     dispatch groups and passes make; the same rows at 480x270 on the card
     and with --device cpu (the plain passes), byte for byte; the negative
     rows (exit nonzero) and the corrupt folders (exit nonzero with the
     marker); the --shard rows print SKIP on one card; the phase's wall
     time. Its launches are added to the rows of the kernels it ran.
then the glue kernel (run_glue, ops/cuda/upscale.py):
 24. each form of csrc/upscale.cu against its plain version, bit for bit, on
     the inputs the main paths hand it (phase 2's frames: Y 2x and packed
     U/V; phase 7's 1.5x; phase 14's uint16 frames at 10 and 16 bits;
     phase 19's LR stack and the inter-pass upscale of its pass-1 stack),
     each timed beside its plain version, its bytes' bound and
     torch.nn.functional.interpolate of the same planes as float32; the
     glue of one 2x step from the profiler, the plain chain's launches and
     device ms beside the step's; the kernel's launches on every path
     driven (each path counts them from 0, as it counts the fused passes).
With --cards N it runs none of these phases, but the engine's data=N, rows=N
and data=N/2,rows=2 over N real cards against the unsharded engine and the
one-card mesh, their times, a card-to-card copy, train_step_sharded over N
cards against the one-card mesh, bit for bit, and the sweep's --shard rows
that N cards can serve, each against the same row without --shard, byte for
byte.
Each path is driven with the launch counts set to 0 just before it and read
just after. A time is one pair of CUDA events around back-to-back calls,
over their count, so the device's pace and not the host's enqueue sets it. The `kernels` line gives every kernel form its bound (bound_ms,
bound_by: the larger of its bytes over 3.35 TB/s and its dot's operations
over the peak of their type) and library_ms, the time of one PyTorch call
computing the same function where there is one (torch._int_mm for the
probe, the one-hot torch.matmul form for the normal equations,
torch.nn.functional.interpolate for the glue). Its last line is {"ok": true, "device": {...}}. It imports nothing of jax or
raisr_tpu, and exits non-zero, with no result line, when there is no CUDA
card or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

N_FRAMES, LR_H, LR_W = 4, 1080, 1920
PASSES = 2
PASSES_15X = 1
QSTR = (0.001269, 0.022169)
QCOH = (0.192916, 0.405942)
# kernel vs its plain version: both round every step alike (nvcc
# --fmad=false), so they must agree bit for bit
KERNEL_MAX_ABS_ERR = 0.0
FUZZ_MAX_FRAC = 0.02  # fused vs taps engine, the JAX package's bar
# the least time the card could take (the `kernels` line's bound_ms): an
# H100 SXM's device memory rate and peak rates (NVIDIA's data sheet, dense,
# at the full 700 W): float32 outside the tensor cores, bfloat16 and int8 in
# them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
DOT_OPS = 2 * 121  # a pixel's 121-tap dot: one multiply and one add per tap
# the hash launch's float operations a pixel: 2 gradients, 3 products, the
# 11-tap vertical and horizontal sums of 3 maps (2 * 3 * 11 * 2), 3 scalings
# and ~30 of eigen-analysis, atan2 and binning
HASH_OPS = 170
# phase 20: HR frames of the training clip; the one-hot form's chunk (JAX's
# TrainConfig.chunk); a pixel's multiply-adds in the normal equations (the
# upper triangle of the 122 x 122 augmented Gram: Q's 121 x 122 / 2 and V's
# 121); the kernel against its float64 plain version, relative to each
# filter's largest entry (sound runs read ~3e-7 on 1080p pairs)
TRAIN_FRAMES = 8
ONEHOT_CHUNK = 2048
NORMAL_EQ_MACS = 121 * 122 // 2 + 121
NORMAL_EQ_MAX_REL_ERR = 1e-5
# phase 22: bytes each strided row holds past its samples (in and out), and
# the value the output planes are filled with beforehand
CAPI_ROW_PAD = 64
CAPI_SENTINEL = 0xAB
# the glue kernel (csrc/upscale.cu): its launches on every path driven, by
# phase (glue_read), and the float operations an output value takes: 2x ~7
# (the column pair's 3 a value halved, the row blend's 3, the round and
# clamp's 3), the vectors ~12 (2 x 3 on rows, 3 on columns, the division,
# round and clamp), 1x none
GLUE_LAUNCHES: dict[str, int] = {}
GLUE_OPS = {"1x": 0, "2x": 7, "vec": 12}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def as_f64(t):
    """A plane as float64: uint16 through the engine's unpacking (few CUDA
    kernels take uint16), anything else by a cast."""
    import torch

    from raisr_tpu_torch.ops.cuda.upscale import unpack_planes

    return (unpack_planes(t) if t.dtype == torch.uint16 else t).to(torch.float64)


def diff_stats(a, b) -> tuple[float, float, float]:
    """(share of differing pixels, median and max absolute difference)."""
    d = (as_f64(a) - as_f64(b)).abs()
    return (float((d > 0).double().mean()), float(d.median()), float(d.max()))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(in_bytes: int, out_bytes: int, ops: float, op_type: str) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes moved (each input read once, each output written once) over the
    device memory's rate and the operations over the peak rate of their
    type. Returns the `kernels` line's bound_ms and bound_by."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pass_bound(plane, *inputs, op_type: str = "float32") -> dict:
    """Bound of a kernel that reads `plane` and `inputs` (bank, buckets,
    bias) and writes one float32 value per pixel, counting the dot's
    operations alone: the hash's ~170 more per pixel are left out, so the
    bound of a kernel with the hash is loose. A bank's dot is counted at the
    rate of the bank's type: a bf16 bank's (the 8-bit bf16 tier, pcenter,
    p_split) at the bfloat16 rate, the int8 tier's integer dot at the int8
    rate."""
    return bound(nbytes(plane, *inputs), plane.numel() * 4, plane.numel() * DOT_OPS, op_type)


def hold(phase: str, label: str, got, want) -> float:
    """The kernel's output against its plain version: print the share of
    differing pixels, fail unless finite and within KERNEL_MAX_ABS_ERR.
    Returns the max absolute difference."""
    import torch

    frac, med, mx = diff_stats(got, want)
    print(f"phase {phase} vs plain, {label}: differing {frac:.6%}, "
          f"median {med}, max {mx}")
    if not (torch.isfinite(got).all() and mx <= KERNEL_MAX_ABS_ERR):
        raise SystemExit(f"phase {phase} failed: {label}")
    return mx


def make_bank(folder: str, passes: int = PASSES, pixel_types: int = 4,
              ratio: float = 2.0, seed: int = 0, bits: int = 8):
    """Write and reload a bank of the real shape (216 buckets x pixel_types
    phases x 121 taps; 4 phases for 2x, 1 for 1.5x): centre tap 1 plus noise
    of 0.01, from `seed`, as the filter folder of `bits`."""
    import numpy as np

    from raisr_tpu_torch import RaisrConfig, load_model
    from raisr_tpu_torch.model.loader import FilterBank
    from raisr_tpu_torch.train.export import save_filter_folder

    rng = np.random.default_rng(seed)
    rows = 216 * pixel_types
    banks = []
    for _ in range(passes):
        filters = np.zeros((rows, 128), np.float32)
        filters[:, :121] = rng.normal(size=(rows, 121)).astype(np.float32) * 0.01
        filters[:, 60] += 1.0
        banks.append(FilterBank(
            filters=filters, qstr=np.asarray(QSTR, np.float32),
            qcoh=np.asarray(QCOH, np.float32), pixel_types=pixel_types,
            taps=121, source_dtype="fp32",
        ))
    save_filter_folder(folder, banks, bits=bits)
    return load_model(folder, RaisrConfig(passes=passes, ratio=ratio, bits=bits))


def make_planes(n: int, h: int, w: int, seed: int, device, bits: int = 8):
    """Smooth seeded content, packed as the engine takes it: uint8 in
    [16, 235] at 8 bits, uint16 in [64, 940] at 10 and over the full range
    at 16; coarse and fine noise, bilinearly enlarged on the card, so edges
    of every orientation occur."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from raisr_tpu_torch.ops.cuda.upscale import pack_planes

    rng = np.random.default_rng(seed)
    out = torch.zeros((n, 1, h, w), device=device)
    for scale, amp in ((32, 1.0), (4, 0.25)):
        noise = torch.tensor(
            rng.normal(size=(n, 1, h // scale + 1, w // scale + 1)),
            dtype=torch.float32, device=device,
        )
        out += amp * F.interpolate(noise, size=(h, w), mode="bilinear",
                                   align_corners=False)
    out = (out - out.amin()) / (out.amax() - out.amin())
    lo, hi = {8: (16, 235), 10: (64, 940), 16: (0, 65535)}[bits]
    return pack_planes(torch.round(lo + out[:, 0] * (hi - lo)),
                       torch.uint8 if bits == 8 else torch.uint16)


def make_patchwork(h: int, w: int, seed: int, device, blk: int = 16):
    """An 8-bit plane of blk x blk blocks, each two crossed gratings of a
    random angle, frequency and amplitude (log-uniform over three decades),
    so that neighbouring pixels often fall in different buckets and the
    hash's buckets spread over nearly all 216: the content on which launch
    A2's bank reads are least often broadcasts. Integer-valued float32 in
    [0, 255], made on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nby, nbx = -(-h // blk), -(-w // blk)

    def draw(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, (nby, nbx, 1, 1)), device=device)

    th, f = draw(0.0, np.pi), draw(0.1, 0.8)
    a = 127.5 * torch.exp(draw(np.log(1e-3), 0.0))
    b = a * draw(0.0, 1.0)
    p1, p2 = draw(0.0, 6.0), draw(0.0, 6.0)
    yy, xx = torch.meshgrid(torch.arange(blk, dtype=torch.float64, device=device),
                            torch.arange(blk, dtype=torch.float64, device=device),
                            indexing="ij")
    v = (a * torch.sin(f * (torch.cos(th) * xx + torch.sin(th) * yy) + p1)
         + b * torch.sin(f * (-torch.sin(th) * xx + torch.cos(th) * yy) + p2) + 127.5)
    img = v.permute(0, 2, 1, 3).reshape(nby * blk, nbx * blk)[:h, :w]
    return torch.clamp(torch.round(img), 0, 255).to(torch.float32).contiguous()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Device time of one call: one pair of CUDA events around `iters`
    back-to-back calls (after `warmup` calls), over `iters`. The host
    enqueues ahead of the device, so a call that takes longer on the device
    than its wrapper takes on the host is timed at the device's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Device time of one call of a microsecond kernel: `calls` calls
    captured in one CUDA graph, its replay timed by cuda_ms, over `calls`.
    The host's enqueue (the wrapper's checks, allocation and launch) is
    left out of the timed window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, replays, 1) / calls


def gather_forms() -> list[str]:
    """Each A2 form's registers, as ptxas left them in the built library
    (`cuobjdump -res-usage`), and the dynamic shared memory it asks for at
    216 buckets (flk.gather_smem_bytes)."""
    import re

    from raisr_tpu_torch.ops.cuda import _build
    from raisr_tpu_torch.ops.cuda import filter_kernel as flk

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(_build.build())], capture_output=True,
                          text=True).stdout
    tiers = ("float32", "bfloat16", "pcenter", "int8")
    lines = []
    for m in re.finditer(r"gather_resident_kernelILi(\d)ELNS_4TierE(\d)E([hi])E\S*\s+"
                         r"REG:(\d+) STACK:(\d+)", text):
        phases, tier, hashed = int(m[1]), tiers[int(m[2])], m[3] == "h"
        smem = flk.gather_smem_bytes(216, phases, tier, hashed)
        lines.append(f"<{phases}, {tier}, {'uint8_t' if hashed else 'int'}>: {m[4]} registers, "
                     f"{m[5]} B stack, {smem} B of dynamic shared memory at 216 buckets")
    return lines or ["registers not read (no cuobjdump output)"]


def zero(counts: dict) -> None:
    """Sets every launch count of a wrapper's dict to 0."""
    counts.update(dict.fromkeys(counts, 0))


def glue_zero() -> None:
    """Sets the glue kernel's launch counts (ops/cuda/upscale.py) to 0, just
    before a path is driven."""
    from raisr_tpu_torch.ops.cuda import upscale as up

    zero(up.UPSCALE_LAUNCHES)


def glue_read(phase: str) -> int:
    """The glue kernel's launches since glue_zero, just after a path was
    driven: added to the `cheap_upscale` row under `phase` and returned."""
    from raisr_tpu_torch.ops.cuda import upscale as up

    n = sum(up.UPSCALE_LAUNCHES.values())
    GLUE_LAUNCHES[phase] = GLUE_LAUNCHES.get(phase, 0) + n
    return n


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _kernel_group(name: str) -> str:
    for key, label in (("hash_bucket_kernel", "launch A1 hash_bucket_kernel"),
                       ("gather_resident_kernel", "launch A2 gather_resident_kernel"),
                       ("epilogue_kernel", "launch B epilogue_kernel"),
                       ("gram_partials_kernel", "normal_eq gram_partials_kernel"),
                       ("gram_reduce_kernel", "normal_eq gram_reduce_kernel"),
                       ("cheap_upscale_kernel", "glue cheap_upscale_kernel"),
                       ("Sort", "sort"), ("sort", "sort"),
                       ("CatArrayBatchedCopy", "PyTorch cat"),
                       ("gather", "PyTorch gather (non-2x resize)"),
                       ("elementwise", "PyTorch elementwise")):
        if key in name:
            return label
    return "other"


def trace(step, steps: int, path: str) -> tuple[list, list]:
    """Trace `steps` calls of `step` with torch.profiler into `path`;
    returns the device kernels' events and the calls' host spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function("serving_step"):
                step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    marks = [e for e in events if e.get("name") == "serving_step" and "dur" in e]
    return kernels, marks


def kernel_groups(kernels) -> dict[str, float]:
    """Device microseconds by kernel group."""
    groups: dict[str, float] = {}
    for e in kernels:
        g = _kernel_group(e["name"])
        groups[g] = groups.get(g, 0.0) + float(e["dur"])
    return groups


def pass_breakdown(fn, calls: int = 10) -> str:
    """Device ms per call of each kernel of one fused pass (A1, A2, B), from
    a torch.profiler trace of `calls` calls."""
    with tempfile.TemporaryDirectory() as tmp:
        kernels, _ = trace(fn, calls, os.path.join(tmp, "pass.json"))
    groups = kernel_groups(kernels)
    return ", ".join(f"{g.split()[1]} {us / calls / 1000:.4f}" for g, us in
                     sorted(groups.items()) if g.startswith("launch"))


def profile_steps(step, out_dir: str, card: str, steps: int = 10,
                  phase: int = 5, name: str = "step_trace.json") -> None:
    """Phase 5 (and 9): trace `steps` serving steps; print the device time
    per step by kernel group and the busy share: the union of the kernels'
    device intervals over the window from the first step's start on the host
    to the last kernel's end."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    kernels, marks = trace(step, steps, path)
    if not kernels or not marks:
        raise SystemExit(f"phase {phase} failed: the trace holds no device kernels")
    t0 = min(float(e["ts"]) for e in marks)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in kernels)
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    groups = kernel_groups(kernels)
    total = sum(groups.values())
    print(f"phase {phase} profile on {card}: {steps} steps, {len(kernels) / steps:g} "
          f"kernels per step, trace {path}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"phase {phase}   {g}: {us / steps / 1000:.3f} ms per step, "
              f"{100 * us / total:.1f}% of kernel time")
    print(f"phase {phase} device busy {busy / 1000:.3f} of {(t1 - t0) / 1000:.3f} ms "
          f"of the traced window = {100 * busy / (t1 - t0):.1f}%")


def run_15x(y, u, v, dev, card: str, kw: dict, profile_dir: str | None):
    """Phases 6-9: the 1.5x path (single-phase kernel) on the frames of the
    2x phases. Returns the kernel's entry of the `kernels` line, and what the
    later phases reuse: the bank, its launch arguments, the 1620x2880 plane,
    the stack, the served frames and the step time."""
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up
    from raisr_tpu_torch.ops.resize import cheap_upscale, cheap_upscale_stacked

    with tempfile.TemporaryDirectory() as folder:
        model = make_bank(folder, passes=PASSES_15X, pixel_types=1, ratio=1.5, seed=15)
    cfg = RaisrConfig(ratio=1.5, passes=PASSES_15X)
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    ch, cw = cfg.output_size(LR_H // 2, LR_W // 2)
    filters = torch.tensor(model.banks[0].filters, device=dev)
    kw = dict(kw, qstr=tuple(float(q) for q in model.banks[0].qstr),
              qcoh=tuple(float(q) for q in model.banks[0].qcoh))
    errs = []

    # -- phase 6: the single-phase kernel against its plain version -----------
    cheap = cheap_upscale(y[0].to(torch.float32), out_h, out_w, 8)
    for blending in (1, 2):
        errs.append(hold(
            "6 single-phase kernel", f"blending {blending}, one {out_h}x{out_w} plane",
            fk.raisr_pass_full(cheap, filters, blending=blending, pixel_types=1, **kw),
            fk.raisr_pass_full_reference(cheap, filters, blending=blending, pixel_types=1,
                                         **kw)))
    # the launch of the 1.5x path: the stack of all frames, LR guard 6 rows,
    # 9 after the upscale, every row held
    lr_pad, hr_pad = 6, 6 * out_h // LR_H
    stack_lr = up.guard_band_stack(y.to(torch.float32), lr_pad)
    stack = cheap_upscale_stacked(stack_lr, N_FRAMES, LR_H, lr_pad, out_h, hr_pad, out_w, 8)
    skw = dict(kw, blending=2, frame_h=out_h, frame_pad=hr_pad)
    got = fk.raisr_pass_full(stack, filters, pixel_types=1, **skw)
    errs.append(hold(
        "6 single-phase kernel", f"the {N_FRAMES}-frame stack {tuple(stack.shape)} "
        f"(frame_h {out_h}, frame_pad {hr_pad})",
        got, fk.raisr_pass_full_reference(stack, filters, pixel_types=1, **skw)))
    stack_y = got.reshape(N_FRAMES, out_h + 2 * hr_pad, out_w)[:, hr_pad: hr_pad + out_h]

    # -- phase 7: the 1.5x path ------------------------------------------------
    engine = RaisrEngine(cfg, model, device=dev)
    torch.cuda.synchronize()
    zero(fk.LAUNCHES)
    glue_zero()
    oy, ou, ov = engine.process_batch_device(y, u, v)
    torch.cuda.synchronize()
    launches = fk.LAUNCHES[("float32", 1)]
    glue = dict(up.UPSCALE_LAUNCHES)
    if glue_read("7") != 3 or glue["vec"] != 3:
        raise SystemExit(f"phase 7 failed: glue launches {glue}, expected 3 of the vectors' form")
    ok_shapes = (
        tuple(oy.shape) == (N_FRAMES, out_h, out_w)
        and tuple(ou.shape) == tuple(ov.shape) == (N_FRAMES, ch, cw)
        and oy.dtype == ou.dtype == ov.dtype == torch.uint8
        and oy.device.type == ou.device.type == ov.device.type == "cuda"
    )
    print(f"phase 7 1.5x path: Y {tuple(oy.shape)} U/V {tuple(ou.shape)} {oy.dtype} "
          f"on {oy.device}, single-phase kernel passes launched {launches}, "
          f"all {fk.LAUNCHES}")
    if not ok_shapes or launches != PASSES_15X or sum(fk.LAUNCHES.values()) != launches:
        raise SystemExit("phase 7 failed: shapes, dtype, device or launch count")
    if not torch.equal(oy, stack_y.to(torch.uint8)):
        raise SystemExit("phase 7 failed: Y differs from phase 6's stacked launch")
    ref_engine = RaisrEngine(RaisrConfig(ratio=1.5, passes=PASSES_15X, backend="reference"),
                             model, device=dev)
    for i in range(N_FRAMES):
        x = fk.raisr_pass_full_reference(
            cheap_upscale(y[i].to(torch.float32), out_h, out_w, 8), filters,
            blending=2, pixel_types=1, **kw)
        frac, med, mx = diff_stats(oy[i], x)
        print(f"phase 7 Y frame {i} vs plain pass: differing {frac:.6%}, "
              f"median {med}, max {mx}")
        if mx > KERNEL_MAX_ABS_ERR:
            raise SystemExit(f"phase 7 failed: Y frame {i} against the plain pass")
        frac, med, mx = diff_stats(oy[i], ref_engine.upscale_y(y[i].to(torch.float32)))
        print(f"phase 7 Y frame {i} vs taps engine: differing {frac:.6%}, "
              f"median {med}, max {mx}")
        if not (frac < FUZZ_MAX_FRAC and med == 0.0):
            raise SystemExit(f"phase 7 failed: Y frame {i} against the taps engine")
    for name, got, src in (("U", ou, u), ("V", ov, v)):
        for i in range(N_FRAMES):
            want = up.cheap_upscale_planes_reference(src[i], ch, cw, 8, torch.uint8)
            if not torch.equal(got[i], want):
                raise SystemExit(f"phase 7 failed: {name} frame {i} differs")
    print(f"phase 7 U/V equal the plain chroma upscale: yes; glue launches {glue}")

    # -- phase 8: CUDA graph capture of the 1.5x step --------------------------
    (gy, gu, gv), graph = graph_step(engine, y, u, v)
    same = torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)
    print(f"phase 8 CUDA graph replay of the 1.5x step equals eager: {same}")
    if not same:
        raise SystemExit("phase 8 failed")

    # -- phase 9: times ----------------------------------------------------------
    dkw = dict(kw, blending=2, pixel_types=1)
    ms_kernel = cuda_ms(lambda: fk.raisr_pass_full(cheap, filters, **dkw), 20, 3)
    ms_plain = cuda_ms(lambda: fk.raisr_pass_full_reference(cheap, filters, **dkw), 3)
    ms_kernel2 = cuda_ms(lambda: fk.raisr_pass_full(cheap, filters, **dkw), 20, 3)
    ms_stack = cuda_ms(lambda: fk.raisr_pass_full(stack, filters, pixel_types=1, **skw), 10, 2)
    ms_resize = cuda_ms(lambda: cheap_upscale_stacked(
        stack_lr, N_FRAMES, LR_H, lr_pad, out_h, hr_pad, out_w, 8), 10, 2)
    ms_step = cuda_ms(lambda: engine.process_batch_device(y, u, v), 10, 2)
    ms_graph = cuda_ms(graph.replay, 10, 2)
    print(f"phase 9 times on {card}: single-phase pass {out_h}x{out_w} kernel "
          f"{ms_kernel:.3f} / {ms_kernel2:.3f} ms (before / after plain), plain "
          f"{ms_plain:.3f} ms; kernel over the {tuple(stack.shape)} stack "
          f"{ms_stack:.3f} ms; stacked 1.5x resize {ms_resize:.3f} ms; serving "
          f"step {N_FRAMES} frames eager {ms_step:.3f} ms = "
          f"{N_FRAMES * 1000 / ms_step:.2f} frames/s, graph {ms_graph:.3f} ms = "
          f"{N_FRAMES * 1000 / ms_graph:.2f} frames/s")
    if profile_dir:
        profile_steps(lambda: engine.process_batch_device(y, u, v), profile_dir, card,
                      phase=9, name="step15_trace.json")
    row = kernel_row("full_kernel_single", "raisr_tpu_torch/csrc/full_kernel.cu",
                     "raisr_tpu/ops/pallas/full_kernel.py:952", launches, errs,
                     ms_kernel, ms_plain, pass_bound(cheap, filters))
    ctx = dict(model=model, filters=filters, kw=kw, cheap=cheap, stack=stack,
               skw=skw, oy=oy, ms_step=ms_step, ms_graph=ms_graph)
    return row, ctx


def psnr(a, b, peak: float = 255.0) -> float:
    import math

    mse = float(((as_f64(a) - as_f64(b)) ** 2).mean())
    return math.inf if mse == 0 else 10 * math.log10(peak * peak / mse)


def kernel_row(name: str, source: str, replaces: str, launches: int, errs,
               ms: float, plain_ms: float, bnd: dict,
               library_ms: float | None = None) -> dict:
    """One entry of the `kernels` line; library_ms is the time of one
    PyTorch call computing the same function, where there is one."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, **bnd, "library_ms": library_ms}


def run_filter(y, dev, card: str, model, kw: dict, c15: dict, b_launches: int) -> list[dict]:
    """Phase 10: the filter apply (apply_filters, both phase counts) and
    launch A alone (apply_filters_hash) on the 2x and 1.5x paths' own planes,
    each held against its plain version, bit for bit (launch A also on a
    patchwork plane); the staged pass (apply_filters, then the plain
    epilogue) against the fused pass; the refusal of a bank over shared
    memory; launch B alone (pass_epilogue) against the plain epilogue and its
    times, and its packed store on the 2x stack against float32 out and
    pack_planes, both timed; launch A1 alone (hash_buckets) against the plain hash, byte for
    byte, timed on the 4K plane and both stacks beside their interior and
    edge tiles (hash_tile_counts); then times that split launch A into hash
    and gather, on smooth and patchwork content. `b_launches`: launch B's
    count on the main path. Returns four `kernels` rows."""
    import torch

    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import filter_kernel as flk
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up
    from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
    from raisr_tpu_torch.ops.resize import cheap_upscale

    out_h, out_w = 2 * LR_H, 2 * LR_W
    f = torch.tensor(model.banks[0].filters, device=dev)
    hkw = dict(k1d=kw["k1d"], nf=kw["nf"],
               qstr=tuple(float(q) for q in model.banks[0].qstr),
               qcoh=tuple(float(q) for q in model.banks[0].qcoh))
    pkw = dict(kw, **hkw, blending=2)
    f15, cheap15, stack15 = c15["filters"], c15["cheap"], c15["stack"]
    hkw15 = {k: c15["kw"][k] for k in ("k1d", "nf", "qstr", "qcoh")}
    cheap = cheap_upscale(y[0].to(torch.float32), out_h, out_w, 8)
    # pass 1's input on the 2x path: the 4-frame guard-banded stack
    lr_pad = 6
    stack = cheap_upscale(up.guard_band_stack(y.to(torch.float32), lr_pad),
                          2 * (LR_H + 2 * lr_pad) * N_FRAMES, out_w, 8)
    skw = dict(pkw, frame_h=out_h, frame_pad=2 * lr_pad)
    gen = torch.Generator(device=dev).manual_seed(10)
    rand = torch.randint(-8, 232, cheap.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    buckets = flk.hash_buckets_reference(cheap, **hkw)
    # the content on which A2's bank reads are least often broadcasts
    patch = make_patchwork(out_h, out_w, 10, dev)
    buckets_patch = flk.hash_buckets_reference(patch, **hkw)
    buckets_stack = flk.hash_buckets_reference(stack, **hkw)
    buckets15 = flk.hash_buckets_reference(stack15, **hkw15)
    torch.cuda.synchronize()

    def finish(x, raw, frame_h=0, frame_pad=0, blending=2, **zone):
        return _finish_pass(x, raw, min_val=kw["min_val"], max_val=kw["max_val"],
                            blending=blending, loop_margin=6,
                            col_end=processed_col_end(x.shape[1], 6, True),
                            frame_h=frame_h, frame_pad=frame_pad, **zone)

    # the path of this phase: each kernel on the planes the serving paths
    # hand the fused pass, with the counts set to 0 just before
    flk.LAUNCHES = flk.SINGLE_LAUNCHES = flk.HASH_LAUNCHES = 0
    raw_stack = flk.apply_filters(stack, buckets_stack, f)
    raw_rand = flk.apply_filters(cheap, rand, f)
    raw_hash = flk.apply_filters_hash(stack, f, **hkw)
    raw15 = flk.apply_filters(stack15, buckets15, f15, pixel_types=1, ratio=1)
    torch.cuda.synchronize()
    counts = (flk.LAUNCHES, flk.SINGLE_LAUNCHES, flk.HASH_LAUNCHES)
    print(f"phase 10 launches: apply_filters 4-phase {counts[0]}, 1-phase "
          f"{counts[1]}, apply_filters_hash {counts[2]}")
    if counts != (2, 1, 1):
        raise SystemExit("phase 10 failed: launch counts")

    errs4, errs1, errsh = [], [], []
    errs4.append(hold("10 apply_filters", f"real buckets, the {tuple(stack.shape)} stack",
                      raw_stack, flk.apply_filters_reference(stack, buckets_stack, f)))
    errs4.append(hold("10 apply_filters", f"uniform buckets in [-8, 232), one "
                      f"{out_h}x{out_w} plane", raw_rand,
                      flk.apply_filters_reference(cheap, rand, f)))
    bad = (rand < 0) | (rand >= 216)
    if not bool((raw_rand[bad] == 0).all()):
        raise SystemExit("phase 10 failed: an out-of-range bucket gave a non-zero raw")
    errsh.append(hold("10 apply_filters_hash", f"the {tuple(stack.shape)} stack", raw_hash,
                      flk.apply_filters_hash_reference(stack, f, **hkw)))
    errsh.append(hold("10 apply_filters_hash", f"a {out_h}x{out_w} patchwork plane "
                      f"({int(torch.unique(buckets_patch).numel())} buckets)",
                      flk.apply_filters_hash(patch, f, **hkw),
                      flk.apply_filters_hash_reference(patch, f, **hkw)))
    errs1.append(hold("10 apply_filters single-phase", f"real buckets, the "
                      f"{tuple(stack15.shape)} stack", raw15,
                      flk.apply_filters_reference(stack15, buckets15, f15, pixel_types=1)))
    # the staged pass equals the fused pass, bit for bit; each result counts
    # in the row of the kernel it holds
    for errs, label, got, want in (
        (errsh, "apply_filters_hash vs apply_filters on the plain hash", raw_hash, raw_stack),
        (errs4, "staged 2x pass vs raisr_pass_full on the stack",
         finish(stack, raw_stack, out_h, 2 * lr_pad), fk.raisr_pass_full(stack, f, **skw)),
        (errs1, "staged 1.5x pass vs raisr_pass_full_single on the stack",
         finish(stack15, raw15, c15["skw"]["frame_h"], c15["skw"]["frame_pad"]),
         fk.raisr_pass_full(stack15, f15, pixel_types=1, **c15["skw"])),
    ):
        errs.append(hold("10 staged", label, got, want))

    # a bank whose rows do not fit in shared memory beside the tile buffers
    # is refused, never gathered from device memory
    for pt, n in ((4, 295), (1, 412)):
        big = torch.zeros((n * pt, 128), device=dev)
        try:
            flk.apply_filters(cheap, rand, big, pixel_types=pt, ratio=2 if pt == 4 else 1)
        except ValueError as e:
            print(f"phase 10 apply_filters refuses {n} buckets x {pt} phases: {e}")
        else:
            raise SystemExit(f"phase 10 failed: a bank of {n} buckets x {pt} phases ran")
    if (flk.LAUNCHES, flk.SINGLE_LAUNCHES) != counts[:2]:
        raise SystemExit("phase 10 failed: a refused bank was launched")

    # launch B alone against the plain epilogue: the 4K plane, both stacks
    # and a row stripe of the plane, both blendings
    errsb = []
    raw_plane = flk.apply_filters(cheap, buckets, f)
    ekw = dict(min_val=kw["min_val"], max_val=kw["max_val"])
    zone15 = dict(frame_h=c15["skw"]["frame_h"], frame_pad=c15["skw"]["frame_pad"])
    top, rows = out_h // 4, out_h // 4
    for blending in (1, 2):
        for label, x, raw, zone in (
            (f"one {out_h}x{out_w} plane", cheap, raw_plane, {}),
            (f"the {tuple(stack.shape)} stack", stack, raw_stack,
             dict(frame_h=out_h, frame_pad=2 * lr_pad)),
            (f"the {tuple(stack15.shape)} stack", stack15, raw15, zone15),
            (f"rows {top}..{top + rows} of the plane as a stripe",
             cheap[top: top + rows], raw_plane[top: top + rows], dict(row0=top, zone_h=out_h)),
        ):
            errsb.append(hold("10 launch B", f"blending {blending}, {label}",
                              fk.pass_epilogue(x, raw, blending=blending, **ekw, **zone),
                              finish(x, raw, blending=blending, **zone)))

    # times: launch A split into hash and gather, each against its plain version
    # (the stack with its frame zones, as the 2x path launches it)
    t = {}
    fused_kw = {"plane": pkw, "patchwork": pkw, "stack": skw}
    for name, x, b in (("plane", cheap, buckets), ("patchwork", patch, buckets_patch),
                       ("stack", stack, buckets_stack)):
        fkw = fused_kw[name]
        t[name] = dict(
            hash_plain=cuda_ms(lambda: flk.hash_buckets_reference(x, **hkw), 3),
            apply=cuda_ms(lambda: flk.apply_filters(x, b, f), 20, 3),
            apply_plain=cuda_ms(lambda: flk.apply_filters_reference(x, b, f), 3),
            hash_apply=cuda_ms(lambda: flk.apply_filters_hash(x, f, **hkw), 20, 3),
            hash_apply_plain=cuda_ms(lambda: flk.apply_filters_hash_reference(x, f, **hkw), 3),
            fused=cuda_ms(lambda: fk.raisr_pass_full(x, f, **fkw), 20, 3),
            fused_plain=cuda_ms(lambda: fk.raisr_pass_full_reference(x, f, **fkw), 3),
        )
    t["plane"]["apply_rand"] = cuda_ms(lambda: flk.apply_filters(cheap, rand, f), 20, 3)
    t["plane"]["apply_rand_plain"] = cuda_ms(
        lambda: flk.apply_filters_reference(cheap, rand, f), 3)
    b15 = flk.hash_buckets_reference(cheap15, **hkw15)
    ms15 = cuda_ms(lambda: flk.apply_filters(cheap15, b15, f15, pixel_types=1, ratio=1), 20, 3)
    ms15_plain = cuda_ms(lambda: flk.apply_filters_reference(cheap15, b15, f15, pixel_types=1), 3)
    ms15_stack = cuda_ms(lambda: flk.apply_filters(stack15, buckets15, f15, pixel_types=1,
                                                   ratio=1), 10, 2)
    # launch B alone, beside its bound: 12 bytes a pixel and no more
    tb = {}
    for name, x, raw, zone in (("plane", cheap, raw_plane, {}),
                               ("stack", stack, raw_stack,
                                dict(frame_h=out_h, frame_pad=2 * lr_pad))):
        for blending in (2, 1):
            tb[name, blending] = cuda_ms(
                lambda: fk.pass_epilogue(x, raw, blending=blending, **ekw, **zone), 20, 3)
        tb[name, "plain"] = cuda_ms(lambda: finish(x, raw, **zone), 3)
        tb[name, "bound"] = bound(nbytes(x, raw), nbytes(x), 0, "float32")["bound_ms"]
        # what the same bytes cost PyTorch: one elementwise add of the two
        # planes into a third (not the epilogue's function; a yardstick of
        # the memory rate a kernel reaches on these planes)
        spare = torch.empty_like(x)
        tb[name, "add"] = cuda_ms(lambda: torch.add(x, raw, out=spare), 20, 3)
        print(f"phase 10 times on {card}, launch B alone, {name} {tuple(x.shape)}: "
              f"CountOfBitsChanged {tb[name, 2]:.4f} ms, Randomness {tb[name, 1]:.4f} ms, "
              f"plain {tb[name, 'plain']:.3f} ms, bound {tb[name, 'bound']:.4f} ms (bytes); "
              f"torch.add of the same planes {tb[name, 'add']:.4f} ms")
    # the last pass's launch B on the 2x stack: float32 out and then the pack
    # of Y (the batched step's route before the packed store) against the
    # packed store, which leaves the guard rows out; equal byte for byte
    zone2 = dict(frame_h=out_h, frame_pad=2 * lr_pad)

    def float_then_pack(dtype):
        # the frames' view packed, as the step packed it (no copy first)
        plane = fk.pass_epilogue(stack, raw_stack, blending=2, **ekw, **zone2)
        frames = plane.reshape(N_FRAMES, -1, out_w)[:, 2 * lr_pad: 2 * lr_pad + out_h]
        return up.pack_planes(frames, dtype).reshape(-1, out_w)

    def packed(dtype):
        return fk.pass_epilogue(stack, raw_stack, blending=2, **ekw, **zone2, out_dtype=dtype)

    for dtype in (torch.uint8, torch.uint16):
        errsb.append(hold("10 launch B packed", f"{dtype} frames of the {tuple(stack.shape)} "
                          "stack vs float32 out and pack_planes", packed(dtype),
                          float_then_pack(dtype)))
        ms_pack = cuda_ms(functools.partial(float_then_pack, dtype), 20, 3)
        ms_packed = cuda_ms(functools.partial(packed, dtype), 20, 3)
        out_bytes = N_FRAMES * out_h * out_w * dtype.itemsize
        bnd = bound(nbytes(stack, raw_stack), out_bytes, 0, "float32")["bound_ms"]
        print(f"phase 10 times on {card}, launch B packed {dtype}, the {tuple(stack.shape)} "
              f"stack: float32 out then pack_planes {ms_pack:.4f} ms, packed store "
              f"{ms_packed:.4f} ms, bound {bnd:.4f} ms (bytes: "
              f"{(nbytes(stack, raw_stack) + out_bytes) / stack.numel():.3f} a stack pixel)")
    a1 = bound(nbytes(cheap), cheap.numel(), cheap.numel() * HASH_OPS, "float32")
    print(f"phase 10 launch A1's bound on the plane: {a1['bound_ms']:.4f} ms ({a1['bound_by']}: "
          f"{HASH_OPS} float operations a pixel, the plane in and a byte a pixel out)")
    # A1 alone: the bucket plane against the plain hash, its time, and the
    # tiles that took the interior path (no bounds tests)
    for name, x, want, hk in (("plane", cheap, buckets, hkw),
                              ("2x stack", stack, buckets_stack, hkw),
                              ("1.5x stack", stack15, buckets15, hkw15)):
        got = flk.hash_buckets(x, **hk)
        tiles = dict(zip(("interior", "edge"), flk.hash_tile_counts(*x.shape)))
        errsh.append(hold("10 hash_buckets (A1 alone)", f"the {name} {tuple(x.shape)}", got,
                          want.to(torch.uint8)))
        ms = cuda_ms(lambda: flk.hash_buckets(x, **hk), 20, 3)
        share = tiles["interior"] / (tiles["interior"] + tiles["edge"])
        print(f"phase 10 A1 alone on {card}, {name} {tuple(x.shape)}: {ms:.4f} ms; tiles "
              f"{tiles['interior']} interior, {tiles['edge']} edge ({100 * share:.2f}% interior)")
    for name, x in (("plane", cheap), ("patchwork", patch), ("stack", stack)):
        r = t[name]
        print(f"phase 10 times on {card}, {name} {tuple(x.shape)}: plain hash "
              f"{r['hash_plain']:.3f} ms; "
              f"apply_filters {r['apply']:.3f} ms (plain {r['apply_plain']:.3f}); "
              f"apply_filters_hash {r['hash_apply']:.3f} ms (plain {r['hash_apply_plain']:.3f}); "
              f"fused pass {r['fused']:.3f} ms (plain {r['fused_plain']:.3f}); the fused "
              f"pass's kernels (torch.profiler), ms: "
              f"{pass_breakdown(lambda: fk.raisr_pass_full(x, f, **fused_kw[name]))}")
    # A2's shared-memory reads, counted: wavefronts a quarter-warp bank load
    # and patch reads a pixel, in the parent's lane order and the kernel's
    slots = flk.bank_slots(24, 3, 3)
    uniform = torch.randint(0, 216, cheap.shape, generator=gen, device=dev)
    for name, b, pt in (("plane", buckets, 4), ("patchwork", buckets_patch, 4),
                        ("uniform random plane", uniform, 4), ("1.5x stack", buckets15, 1)):
        parent, parent_reads = flk.gather_wavefronts(b, pt, order="parent")
        kernel, kernel_reads = flk.gather_wavefronts(b, pt, slots)
        print(f"phase 10 A2 bank reads on the {name}: {int(torch.unique(b).numel())} buckets, "
              f"{parent:.4f} -> {kernel:.4f} wavefronts a quarter-warp load, "
              f"{parent_reads:g} -> {kernel_reads:g} patch reads a pixel (parent's order -> "
              f"the kernel's)")
    # A2 alone over A1's buckets (gather_buckets) on the serving stacks, each
    # form the cells run, against the plain filter apply; its time in the
    # fused pass; each form's registers and shared memory
    for name, x, hk, bank, pt, errs in (("2x stack", stack, hkw, f, 4, errsh),
                                        ("1.5x stack", stack15, hkw15, f15, 1, errs1)):
        b8 = flk.hash_buckets(x, **hk)
        for tier, fb in (("float32", bank), ("bfloat16", fk.round_bf16_error_diffused(bank))):
            errs.append(hold("10 gather_buckets (A2 alone)", f"{tier}, the {name} "
                             f"{tuple(x.shape)}",
                             flk.gather_buckets(x, b8, fb, pixel_types=pt, tier=tier),
                             flk.apply_filters_reference(x, b8.to(torch.int32), fb,
                                                         pixel_types=pt,
                                                         ratio=2 if pt == 4 else 1)))
            fused = dict(skw if pt == 4 else c15["skw"], pixel_types=pt, tier=tier)
            print(f"phase 10 A2 in the fused pass on {card}, {tier}, the {name}: kernels "
                  f"(torch.profiler), ms: "
                  f"{pass_breakdown(lambda: fk.raisr_pass_full(x, fb, **fused))}")
    for line in gather_forms():
        print(f"phase 10 A2 form {line}")
    print(f"phase 10 times on {card}: apply_filters with uniform buckets in [-8, 232) "
          f"{t['plane']['apply_rand']:.3f} ms (plain {t['plane']['apply_rand_plain']:.3f}); "
          f"single-phase apply_filters {tuple(cheap15.shape)} {ms15:.3f} ms (plain "
          f"{ms15_plain:.3f}), over the {tuple(stack15.shape)} stack {ms15_stack:.3f} ms")
    src = "raisr_tpu_torch/csrc/full_kernel.cu"
    return [
        kernel_row("filter_kernel", src, "raisr_tpu/ops/pallas/filter_kernel.py:116",
                   counts[0], errs4, t["plane"]["apply"], t["plane"]["apply_plain"],
                   pass_bound(cheap, buckets, f)),
        kernel_row("filter_kernel_single", src, "raisr_tpu/ops/pallas/filter_kernel.py:374",
                   counts[1], errs1, ms15, ms15_plain, pass_bound(cheap15, b15, f15)),
        kernel_row("hash_filter", src,
                   "raisr_tpu/ops/pallas/filter_kernel.py:514", counts[2], errsh,
                   t["plane"]["hash_apply"], t["plane"]["hash_apply_plain"],
                   pass_bound(cheap, f)),
        # launch B, the last third of the port of _full_kernel: its count on
        # the main path, its time alone on the 4K plane
        kernel_row("full_kernel_epilogue", src, "raisr_tpu/ops/pallas/full_kernel.py:82",
                   b_launches, errsb, tb["plane", 2], tb["plane", "plain"],
                   bound(nbytes(cheap, raw_plane), nbytes(cheap), 0, "float32")),
    ]


def run_bf16(y, u, v, dev, card: str, model, kw: dict, c2: dict, c15: dict,
             profile_dir: str | None) -> list[dict]:
    """Phase 11: the 8-bit bf16 tier (dtype="auto"). The bf16 kernel against
    its plain version on one 4K plane (both blendings) and one 1620x2880
    plane (1 phase); both serving paths through process_batch_device, eager
    and as a replayed CUDA graph, every frame against the plain bf16 passes;
    the difference to the float32 frames and the step times, printed; with
    --profile DIR, 10 traced steps of each path. Returns the `kernels` rows
    and the served Y frames by path ("2x", "1.5x")."""
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.resize import cheap_upscale

    rows, served = [], {}
    for tag, mdl, bkw, cfg, plane, f32_oy, f32_ms in (
        ("2x", model, kw, RaisrConfig(passes=PASSES, dtype="auto"),
         cheap_upscale(y[0].to(torch.float32), 2 * LR_H, 2 * LR_W, 8), c2["oy"], c2["ms_step"]),
        ("1.5x", c15["model"], c15["kw"],
         RaisrConfig(ratio=1.5, passes=PASSES_15X, dtype="auto"), c15["cheap"], c15["oy"],
         c15["ms_step"]),
    ):
        single = tag == "1.5x"
        pt = 1 if single else 4
        banks32 = [torch.tensor(b.filters, device=dev) for b in mdl.banks]
        banks = [fk.round_bf16_error_diffused(b) for b in banks32]
        edges = [dict(qstr=tuple(float(q) for q in b.qstr),
                      qcoh=tuple(float(q) for q in b.qcoh)) for b in mdl.banks]
        pk = dict(bkw, **edges[0], pixel_types=pt, tier="bfloat16")
        errs = []
        for blending in (1, 2):
            errs.append(hold(f"11 bf16 {tag} kernel", f"blending {blending}, one "
                             f"{tuple(plane.shape)} plane",
                             fk.raisr_pass_full(plane, banks[0], **dict(pk, blending=blending)),
                             fk.raisr_pass_full_reference(plane, banks[0],
                                                          **dict(pk, blending=blending))))
        engine = RaisrEngine(cfg, mdl, device=dev)
        torch.cuda.synchronize()
        zero(fk.LAUNCHES)
        glue_zero()
        oy, ou, ov = engine.process_batch_device(y, u, v)
        torch.cuda.synchronize()
        launches = fk.LAUNCHES[("bfloat16", pt)]
        glue = glue_read("11")
        print(f"phase 11 bf16 {tag} path (dtype auto): Y {tuple(oy.shape)}, launches "
              f"{fk.LAUNCHES}, glue {glue}")
        if launches != len(mdl.banks) or sum(fk.LAUNCHES.values()) != launches or glue != 3:
            raise SystemExit(f"phase 11 failed: {tag} launch count")
        out_h, out_w = oy.shape[1:]
        for i in range(N_FRAMES):
            x = cheap_upscale(y[i].to(torch.float32), out_h, out_w, 8)
            for p, bank in enumerate(banks):
                x = fk.raisr_pass_full_reference(x, bank, **dict(pk, **edges[p], blending=2))
            frac, med, mx = diff_stats(oy[i], x)
            f_frac, _, f_mx = diff_stats(oy[i], f32_oy[i])
            print(f"phase 11 bf16 {tag} Y frame {i}: vs plain bf16 passes differing "
                  f"{frac:.6%}, max {mx}; vs the float32 frame differing {f_frac:.6%}, "
                  f"largest {f_mx:g} LSB, PSNR {psnr(oy[i], f32_oy[i]):.2f} dB")
            errs.append(mx)
            if mx > KERNEL_MAX_ABS_ERR:
                raise SystemExit(f"phase 11 failed: {tag} Y frame {i} against the plain passes")
        (gy, gu, gv), graph = graph_step(engine, y, u, v)
        same = torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)
        print(f"phase 11 bf16 {tag} CUDA graph replay equals eager: {same}")
        if not same:
            raise SystemExit(f"phase 11 failed: {tag} graph replay")
        dkw = dict(pk, blending=2)
        fkw = dict(dkw, tier="float32")
        ms32 = cuda_ms(lambda: fk.raisr_pass_full(plane, banks32[0], **fkw), 20, 3)
        ms16 = cuda_ms(lambda: fk.raisr_pass_full(plane, banks[0], **dkw), 20, 3)
        ms16b = cuda_ms(lambda: fk.raisr_pass_full(plane, banks[0], **dkw), 20, 3)
        ms32b = cuda_ms(lambda: fk.raisr_pass_full(plane, banks32[0], **fkw), 20, 3)
        ms_plain = cuda_ms(lambda: fk.raisr_pass_full_reference(plane, banks[0], **dkw), 3)
        ms_step = cuda_ms(lambda: engine.process_batch_device(y, u, v), 10, 2)
        ms_graph = cuda_ms(graph.replay, 10, 2)
        print(f"phase 11 times on {card}, {tag}: fused pass {tuple(plane.shape)} f32 / bf16 / "
              f"bf16 / f32 {ms32:.3f} / {ms16:.3f} / {ms16b:.3f} / {ms32b:.3f} ms (bf16 kernels, "
              f"ms: {pass_breakdown(lambda: fk.raisr_pass_full(plane, banks[0], **dkw))}), "
              f"bf16 plain {ms_plain:.3f} ms; bf16 serving step {N_FRAMES} frames eager {ms_step:.3f} ms "
              f"= {N_FRAMES * 1000 / ms_step:.2f} frames/s, graph {ms_graph:.3f} ms = "
              f"{N_FRAMES * 1000 / ms_graph:.2f} frames/s; float32 step eager {f32_ms:.3f} ms "
              f"= {N_FRAMES * 1000 / f32_ms:.2f} frames/s")
        if profile_dir:
            profile_steps(lambda: engine.process_batch_device(y, u, v), profile_dir, card,
                          phase=11, name=f"step_bf16_{tag}_trace.json")
        rows.append(kernel_row(
            "full_kernel_single_bf16" if single else "full_kernel_bf16",
            "raisr_tpu_torch/csrc/full_kernel.cu",
            "raisr_tpu/ops/pallas/full_kernel.py:" + ("952" if single else "82"),
            launches, errs, ms16, ms_plain, pass_bound(plane, banks[0], op_type="bfloat16")))
        served[tag] = oy
    return rows, served


def run_25x(y, dev, card: str, kw: dict) -> None:
    """Phase 12: a 4-phase (2x) bank at 2.5x (ROADMAP C9), one 1080p frame to
    2700x4800, 1 pass, through the engine on the card: the single-phase
    kernel over the bank's phase-0 rows, against the plain pass and the taps
    engine."""
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.resize import cheap_upscale

    with tempfile.TemporaryDirectory() as folder:
        model = make_bank(folder, passes=1, pixel_types=4, ratio=2.5, seed=25)
    cfg = RaisrConfig(ratio=2.5, passes=1)
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    engine = RaisrEngine(cfg, model, device=dev)
    frame = y[:1]
    torch.cuda.synchronize()
    zero(fk.LAUNCHES)
    glue_zero()
    oy = engine.process_batch_device(frame)[0]
    torch.cuda.synchronize()
    print(f"phase 12 2.5x with a 4-phase bank: Y {tuple(oy.shape)}, launches {fk.LAUNCHES}, "
          f"glue {glue_read('12')}")
    if (tuple(oy.shape) != (1, out_h, out_w)
            or fk.LAUNCHES != {k: int(k == ("float32", 1)) for k in fk.LAUNCHES}):
        raise SystemExit("phase 12 failed: shape or launch count")
    bank = model.banks[0]
    phase0 = torch.tensor(bank.filters[0::4], device=dev).contiguous()
    pkw = dict(kw, qstr=tuple(float(q) for q in bank.qstr),
               qcoh=tuple(float(q) for q in bank.qcoh), blending=2)
    cheap = cheap_upscale(frame[0].to(torch.float32), out_h, out_w, 8)
    frac, med, mx = diff_stats(oy[0], fk.raisr_pass_full_reference(cheap, phase0, pixel_types=1,
                                                                   **pkw))
    print(f"phase 12 Y vs the plain single-phase pass on the phase-0 rows: differing "
          f"{frac:.6%}, max {mx}")
    if mx > KERNEL_MAX_ABS_ERR:
        raise SystemExit("phase 12 failed: Y against the plain pass")
    ref = RaisrEngine(RaisrConfig(ratio=2.5, passes=1, backend="reference"), model, device=dev)
    frac, med, mx = diff_stats(oy[0], ref.upscale_y(frame[0].to(torch.float32)))
    print(f"phase 12 Y vs taps engine: differing {frac:.6%}, median {med}, max {mx}")
    if not (frac < FUZZ_MAX_FRAC and med == 0.0):
        raise SystemExit("phase 12 failed: Y against the taps engine")
    ms = cuda_ms(lambda: engine.process_batch_device(frame), 10, 2)
    print(f"phase 12 time on {card}: 2.5x step, 1 frame {out_h}x{out_w}, {ms:.3f} ms")


def run_tier(phase: int, tag: str, cfg, model, frames, dev, card: str, base=None):
    """Phases 13 and 14, one tier's path: the fused pass at the engine's tier
    against its plain version, bit for bit, on one output-size plane (both
    blendings) and on every launch of the path (each pass over the 4-frame
    guard-banded stack); then the path, process_batch_device on the 4
    frames, with every launch count set to 0 just before it: the tier's
    count must be the pass count and every other 0; every served frame
    against the plain passes and the stacked launches, U/V against the
    chroma upscale, a replayed CUDA graph against eager; the difference to
    `base` (the float32 frames of the same depth and ratio), printed; times
    of the tier's kernel beside the float32 kernel on the same plane, its
    plain version and the step. With cfg.mode == 2 (two passes) pass 1 runs
    at LR size over the stack with a 12-row guard, the upscale comes before
    pass 2 and the guard becomes 24 HR rows. Returns the `kernels` row, the
    served Y frames and the step time."""
    import torch

    from raisr_tpu_torch import RaisrEngine
    from raisr_tpu_torch.ops.cuda.upscale import unpack_planes
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up
    from raisr_tpu_torch.ops.resize import cheap_upscale, cheap_upscale_stacked

    y, u, v = frames
    engine = RaisrEngine(cfg, model, device=dev)
    tier, bits, passes = engine._statics.tier, cfg.bits, cfg.passes
    pt = 4 if cfg.use_pixel_type else 1
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    f32 = [torch.tensor(b.filters, device=dev) for b in model.banks]
    # each pass's bank at the tier, and its extras (pcenter bias, int8 1/scale)
    banks = [(b.filters, dict(tier=tier, pbias=b.pbias, inv_scale=b.inv_scale))
             for b in pipeline.pass_banks(engine._statics, f32)]
    k1d = tuple(float(x) for x in gaussian_kernel_1d(11))

    def pk(p, **kw):
        b = model.banks[p]
        return dict(k1d=k1d, nf=normalization_factor(bits),
                    qstr=tuple(float(q) for q in b.qstr), qcoh=tuple(float(q) for q in b.qcoh),
                    min_val=cfg.min_val, max_val=cfg.max_val, pixel_types=pt, **kw)

    label = f"{phase} {tag} {tier} kernel"
    errs = []
    lr = unpack_planes(y)
    plane = cheap_upscale(lr[0], out_h, out_w, bits)
    bank0, extra0 = banks[0]
    for blending in (1, 2):
        kw = pk(0, blending=blending, **extra0)
        errs.append(hold(label, f"blending {blending}, one {out_h}x{out_w} plane",
                         fk.raisr_pass_full(plane, bank0, **kw),
                         fk.raisr_pass_full_reference(plane, bank0, **kw)))
    # the path's launches: the stack of all frames, LR guard 6 rows (12 when
    # pass 1 runs at LR size), upscaled before the pass of cfg.two_pass_mode
    up_pass = cfg.two_pass_mode - 1
    lr_pad = 12 if up_pass == 1 else 6
    hr_pad = lr_pad * out_h // LR_H
    x = up.guard_band_stack(lr, lr_pad)
    fh, fp = LR_H, lr_pad
    for p, (bank, extra) in enumerate(banks):
        if p == up_pass:
            if out_h == 2 * LR_H:
                x = cheap_upscale(x, 2 * x.shape[0], out_w, bits)
            else:
                x = cheap_upscale_stacked(x, N_FRAMES, LR_H, lr_pad, out_h, hr_pad, out_w, bits)
            fh, fp = out_h, hr_pad
        skw = dict(blending=2, frame_h=fh, frame_pad=fp)
        got = fk.raisr_pass_full(x, bank, **pk(p, **skw, **extra))
        errs.append(hold(label, f"pass {p + 1} over the {N_FRAMES}-frame stack "
                         f"{tuple(x.shape)} (frame_h {fh}, frame_pad {fp})",
                         got, fk.raisr_pass_full_reference(x, bank, **pk(p, **skw, **extra))))
        x = got
    stack_y = x.reshape(N_FRAMES, out_h + 2 * hr_pad, out_w)[:, hr_pad: hr_pad + out_h]

    torch.cuda.synchronize()
    zero(fk.LAUNCHES)
    glue_zero()
    oy, ou, ov = engine.process_batch_device(y, u, v)
    torch.cuda.synchronize()
    counts = dict(fk.LAUNCHES)
    launches = counts[(tier, pt)]
    # the glue: Y, U and V a launch each; mode 2 adds the LR stack's
    glue = glue_read(str(phase))
    print(f"phase {phase} {tag} path ({cfg.dtype}, {bits} bits, tier {tier}): Y "
          f"{tuple(oy.shape)} {oy.dtype}, launches {counts}, glue {dict(up.UPSCALE_LAUNCHES)}")
    ch, cw = cfg.output_size(LR_H // 2, LR_W // 2)
    out_dtype = torch.uint8 if bits == 8 else torch.uint16
    if (tuple(oy.shape) != (N_FRAMES, out_h, out_w) or tuple(ou.shape) != (N_FRAMES, ch, cw)
            or not oy.dtype == ou.dtype == ov.dtype == out_dtype
            or launches != passes or sum(counts.values()) != launches
            or glue != 3 + (up_pass == 1)):
        raise SystemExit(f"phase {phase} failed: {tag} shapes, dtype or launch count")
    oyf = unpack_planes(oy)
    if not torch.equal(oyf, stack_y):
        raise SystemExit(f"phase {phase} failed: {tag} Y differs from the stacked launches")
    peak = float((1 << bits) - 1)
    for i in range(N_FRAMES):
        x = lr[i]
        for p, (bank, extra) in enumerate(banks):
            if p == up_pass:
                x = cheap_upscale(x, out_h, out_w, bits)
            x = fk.raisr_pass_full_reference(x, bank, **pk(p, blending=2, **extra))
        frac, _, mx = diff_stats(oyf[i], x)
        line = f"phase {phase} {tag} Y frame {i}: vs plain passes differing {frac:.6%}, max {mx}"
        if base is not None:
            b_frac, _, b_mx = diff_stats(oy[i], base[i])
            line += (f"; vs the float32 frame differing {b_frac:.6%}, largest {b_mx:g} LSB, "
                     f"PSNR {psnr(oy[i], base[i], peak):.2f} dB at peak {peak:g}")
        print(line)
        errs.append(mx)
        if mx > KERNEL_MAX_ABS_ERR:
            raise SystemExit(f"phase {phase} failed: {tag} Y frame {i} against the plain passes")
    for name, got, src in (("U", ou, u), ("V", ov, v)):
        if not torch.equal(unpack_planes(got), up.cheap_upscale_planes_reference(
                src, ch, cw, bits)):
            raise SystemExit(f"phase {phase} failed: {tag} {name} differs")
    (gy, gu, gv), graph = graph_step(engine, y, u, v)
    same = all(torch.equal(unpack_planes(a), unpack_planes(b))
               for a, b in ((gy, oy), (gu, ou), (gv, ov)))
    print(f"phase {phase} {tag} U/V equal the plain chroma upscale: yes; CUDA graph replay "
          f"equals eager: {same}")
    if not same:
        raise SystemExit(f"phase {phase} failed: {tag} graph replay")

    dkw, fkw = pk(0, blending=2, **extra0), pk(0, blending=2)
    ms32 = cuda_ms(lambda: fk.raisr_pass_full(plane, f32[0], **fkw), 20, 3)
    ms = cuda_ms(lambda: fk.raisr_pass_full(plane, bank0, **dkw), 20, 3)
    ms_b = cuda_ms(lambda: fk.raisr_pass_full(plane, bank0, **dkw), 20, 3)
    ms32_b = cuda_ms(lambda: fk.raisr_pass_full(plane, f32[0], **fkw), 20, 3)
    ms_plain = cuda_ms(lambda: fk.raisr_pass_full_reference(plane, bank0, **dkw), 3)
    ms_step = cuda_ms(lambda: engine.process_batch_device(y, u, v), 10, 2)
    ms_graph = cuda_ms(graph.replay, 10, 2)
    print(f"phase {phase} times on {card}, {tag}: fused pass {tuple(plane.shape)} f32 / "
          f"{tier} / {tier} / f32 {ms32:.3f} / {ms:.3f} / {ms_b:.3f} / {ms32_b:.3f} ms, "
          f"{tier} plain {ms_plain:.3f} ms; serving step {N_FRAMES} frames eager "
          f"{ms_step:.3f} ms = {N_FRAMES * 1000 / ms_step:.2f} frames/s, graph "
          f"{ms_graph:.3f} ms = {N_FRAMES * 1000 / ms_graph:.2f} frames/s")
    form = {"float32": "f32", "pcenter": "pcenter", "int8": "int8"}.get(
        tier, "bf16" if bits == 8 else "p_split")
    row = kernel_row(
        f"full_kernel{'_single' if pt == 1 else ''}_{form}_{bits}bit"
        + ("_mode2" if up_pass == 1 else ""),
        "raisr_tpu_torch/csrc/full_kernel.cu",
        "raisr_tpu/ops/pallas/full_kernel.py:" + ("82" if pt == 4 else "952"),
        launches, errs, ms, ms_plain,
        pass_bound(plane, bank0, extra0.get("pbias"),
                   op_type={"float32": "float32", "int8": "int8"}.get(tier, "bfloat16")))
    return row, oy, ms_step


def run_hibit(dev, card: str) -> list[dict]:
    """Phase 14: the >8-bit tiers on uint16 frames, 4 x 1080p. At 10 bits,
    2x, 2 passes: float32, bfloat16 (pcenter) and bfloat16_exact (p_split);
    at 16 bits, 2x, 1 pass: float32 and bfloat16 (p_split); at 10 bits,
    1080p -> 1620x2880, 1 pass: float32 and bfloat16 (the single-phase
    p_split). Each float32 path comes first and gives the frames the bf16
    tiers are compared with. Returns their `kernels` rows."""
    from raisr_tpu_torch import RaisrConfig

    rows = []
    for bits, ratio, passes, dtypes in (
        (10, 2.0, PASSES, ("float32", "bfloat16", "bfloat16_exact")),
        (16, 2.0, 1, ("float32", "bfloat16")),
        (10, 1.5, PASSES_15X, ("float32", "bfloat16")),
    ):
        pt = 4 if ratio == 2.0 else 1
        with tempfile.TemporaryDirectory() as folder:
            model = make_bank(folder, passes=passes, pixel_types=pt, ratio=ratio,
                              seed=14, bits=bits)
        frames = (make_planes(N_FRAMES, LR_H, LR_W, 41, dev, bits),
                  make_planes(N_FRAMES, LR_H // 2, LR_W // 2, 42, dev, bits),
                  make_planes(N_FRAMES, LR_H // 2, LR_W // 2, 43, dev, bits))
        base = None
        for dtype in dtypes:
            cfg = RaisrConfig(bits=bits, ratio=ratio, passes=passes, dtype=dtype)
            tag = f"{bits}-bit {ratio:g}x {passes}-pass {dtype}"
            row, oy, _ = run_tier(14, tag, cfg, model, frames, dev, card, base)
            base = oy if base is None else base
            rows.append(row)
    return rows


def run_probe(dev, card: str) -> dict:
    """Phase 15: the s8 x s8 -> s32 matmul probe at its shape
    [864, 144] x [144, 512], with the launch count set to 0 just before the
    call: exact against the int64 product and against torch._int_mm, timed
    beside both. Returns its `kernels` row."""
    import numpy as np
    import torch

    from raisr_tpu_torch.ops.cuda import probe_s16 as ps

    rng = np.random.default_rng(15)
    a = torch.tensor(rng.integers(-128, 128, (ps.M, ps.K)).astype(np.int8), device=dev)
    b = torch.tensor(rng.integers(-128, 128, (ps.K, ps.N)).astype(np.int8), device=dev)
    torch.cuda.synchronize()
    ps.LAUNCHES = 0
    c = ps.s8_matmul(a, b)
    torch.cuda.synchronize()
    launches = ps.LAUNCHES
    print(f"phase 15 s8 matmul {tuple(a.shape)} x {tuple(b.shape)} -> {tuple(c.shape)} "
          f"{c.dtype}, launches {launches}")
    if launches != 1 or c.dtype != torch.int32 or tuple(c.shape) != (ps.M, ps.N):
        raise SystemExit("phase 15 failed: launch count, shape or dtype")
    errs = [hold("15 s8 matmul", "the int64 product", c, ps.s8_matmul_reference(a, b))]
    lib_same = torch.equal(c, torch._int_mm(a, b))
    print(f"phase 15 s8 matmul equals torch._int_mm: {lib_same}")
    if not lib_same:
        raise SystemExit("phase 15 failed: against torch._int_mm")
    # each a CUDA graph of 100 calls, replayed; the host's pace alongside
    ms = graph_ms(lambda: ps.s8_matmul(a, b))
    lib = graph_ms(lambda: torch._int_mm(a, b))
    lib_b = graph_ms(lambda: torch._int_mm(a, b))
    ms_b = graph_ms(lambda: ps.s8_matmul(a, b))
    host = cuda_ms(lambda: ps.s8_matmul(a, b), 100, 5)
    host_lib = cuda_ms(lambda: torch._int_mm(a, b), 100, 5)
    plain = cuda_ms(lambda: ps.s8_matmul_reference(a, b), 5, 1)
    print(f"phase 15 times on {card}: s8_matmul / torch._int_mm / torch._int_mm / s8_matmul "
          f"{ms:.5f} / {lib:.5f} / {lib_b:.5f} / {ms_b:.5f} ms (a CUDA graph of 100 calls), "
          f"back-to-back eager calls {host:.5f} / {host_lib:.5f} ms, plain {plain:.3f} ms")
    return kernel_row("s8_matmul", "raisr_tpu_torch/csrc/probe_s16.cu", "tools/probe_s16.py:44",
                      launches, errs, ms, plain,
                      bound(nbytes(a, b), nbytes(c), 2 * ps.M * ps.K * ps.N, "int8"),
                      library_ms=lib)


def host_ms(fn, iters: int) -> float:
    """Host milliseconds per call of a function that only touches host memory."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def write_y4m(path: str, frames) -> None:
    """An 8-bit YUV420 Y4M clip of `frames`, written byte by byte (through
    no writer of the package): what phase 17 hands the CLI."""
    h, w = frames[0].y.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            for p in (fr.y, fr.u, fr.v):
                f.write(p.tobytes())


def frames_equal(got, want) -> bool:
    import numpy as np

    return (len(got) == len(want) and all(
        np.array_equal(a.y, b.y) and np.array_equal(a.u, b.u) and np.array_equal(a.v, b.v)
        and a.y.dtype == b.y.dtype for a, b in zip(got, want)))


def one_stream(sp):
    """Takes a StreamProcessor's side streams away, so that its copies run
    on the step's stream: the form the shipped one is measured against."""
    sp._in = sp._out = None
    return sp


def run_stream(dev, card: str, tmp: str, kw: dict, resident_ms: float):
    """Phase 16: the file-to-file path's middle, StreamProcessor over 24
    distinct 8-bit YUV420 1080p frames in host memory, on a 2-pass bank
    loaded from a folder under `tmp`. Every streamed frame must equal
    engine.process of that frame, bit for bit, at batch 4 (depth 2), at
    batch 1, and on 22 frames (a tail of 2); the fused launches are counted
    (2 a group); the same with the copies on the step's stream; the first
    group's frames are held against the plain passes. Then frames/s at depth
    1, 2 and 4 with batch 4 and at batch 1 (outputs dropped), with the copies
    on side streams and on the step's stream, beside the resident step's rate of phase 4 (`resident_ms` for 4 frames) and the
    times of the copies and the staging alone. Returns the `kernels` row of
    the stream path, and the folder, frames and served frames for phase 17."""
    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.engine import Frame
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up
    from raisr_tpu_torch.ops.resize import cheap_upscale
    from raisr_tpu_torch.stream import StreamProcessor
    from raisr_tpu_torch.utils.profiler import Tracer

    n_clip, batch = 24, 4
    folder = os.path.join(tmp, "bank")
    model = make_bank(folder, seed=16)
    cfg = RaisrConfig(filterfolder=folder, passes=PASSES)
    engine = RaisrEngine(cfg, device=dev)  # loads the folder, as the CLI does
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    planes = [make_planes(n_clip, h, w, seed, dev).cpu().numpy()
              for h, w, seed in ((LR_H, LR_W, 161), (LR_H // 2, LR_W // 2, 162),
                                 (LR_H // 2, LR_W // 2, 163))]
    frames = [Frame(y=planes[0][i], u=planes[1][i], v=planes[2][i]) for i in range(n_clip)]
    if len({fr.y.tobytes() for fr in frames}) != n_clip:
        raise SystemExit("phase 16 failed: the clip's frames are not distinct")
    want = [engine.process(fr) for fr in frames]

    def fused_counts():
        return fk.LAUNCHES[("float32", 4)], sum(fk.LAUNCHES.values()), fk.EPILOGUE_LAUNCHES

    launches = 0
    for label, depth, b, n in (("batch 4, depth 2", 2, batch, n_clip),
                               ("batch 1, depth 2", 2, 1, n_clip),
                               ("batch 4, depth 2, 22 frames (a tail of 2)", 2, batch, 22),
                               ("batch 4, depth 4, copies on the step's stream", 4, batch,
                                n_clip)):
        torch.cuda.synchronize()
        zero(fk.LAUNCHES)
        fk.EPILOGUE_LAUNCHES = 0
        glue_zero()
        sp = StreamProcessor(engine, depth=depth, batch=b)
        if "step's" in label:
            one_stream(sp)
        got = list(sp.process(iter(frames[:n])))
        counts = fused_counts()
        groups = -(-n // b)
        if glue_read("16") != 3 * groups:
            raise SystemExit(f"phase 16 failed: {label}: glue launches, expected 3 a group")
        same = frames_equal(got, want[:n])
        print(f"phase 16 stream, {label}: {len(got)} frames {got[0].y.shape} {got[0].y.dtype}, "
              f"equal to engine.process bit for bit: {same}; fused passes launched "
              f"{counts[0]} (launch B {counts[2]}) in {groups} groups")
        if not same or counts != (PASSES * groups,) * 3:
            raise SystemExit(f"phase 16 failed: {label}")
        if launches == 0:
            launches, served = counts[0], got
    # the first group against the plain passes, frame by frame
    filters = [torch.tensor(b.filters, device=dev) for b in model.banks]
    edges = [dict(qstr=tuple(float(q) for q in b.qstr),
                  qcoh=tuple(float(q) for q in b.qcoh)) for b in model.banks]
    errs = []
    for i in range(batch):
        x = torch.as_tensor(frames[i].y, device=dev).to(torch.float32)
        for p in range(PASSES):
            cur = cheap_upscale(x, out_h, out_w, 8) if p == 0 else x
            x = fk.raisr_pass_full_reference(cur, filters[p], blending=2, **dict(kw, **edges[p]))
        errs.append(hold("16 stream", f"Y frame {i} vs the plain passes",
                         torch.as_tensor(served[i].y, device=dev).to(torch.float32), x))

    # rates: frames from memory, outputs dropped after materialising; each
    # depth twice, interleaved
    clip = frames * 4
    rates = {}
    for side in (True, False):
        for depth, b in ((1, batch), (2, batch), (4, batch), (2, 1)) * 2:
            sp = StreamProcessor(engine, depth=depth, batch=b)
            if not side:
                one_stream(sp)
            # until the allocators hold every block that circulates
            sum(1 for _ in sp.process(iter(frames[:(depth + 2) * b])))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_out = sum(1 for _ in sp.process(iter(clip)))
            rates.setdefault((side, depth, b), []).append(n_out / (time.perf_counter() - t0))
    resident = batch * 1000 / resident_ms
    for side, label in ((True, "copies on side streams (as shipped)"),
                        (False, "copies on the step's stream")):
        r = [f"depth {d} {rates[side, d, batch][0]:.2f} / {rates[side, d, batch][1]:.2f}"
             for d in (1, 2, 4)]
        print(f"phase 16 rates on {card}: StreamProcessor batch {batch}, {len(clip)} frames "
              f"1080p -> 4K, 2 passes, {label}, frames/s at {', '.join(r)}; at batch 1, depth 2 "
              f"{rates[side, 2, 1][0]:.2f} / {rates[side, 2, 1][1]:.2f}; "
              f"process_batch_device alone on resident frames (phase 4) {resident:.2f} frames/s")
    tracer = Tracer()
    sp = StreamProcessor(engine, depth=2, batch=batch, tracer=tracer)
    sum(1 for _ in sp.process(iter(clip)))
    stages = ", ".join(f"{k} {s.count} times, {1e3 * s.total_s:.3f} ms"
                       for k, s in tracer.stages.items())
    print(f"phase 16 Tracer stages of one run at depth 2 (host clock): {stages}")
    # what a group costs apart: the copies on the device's clock, the
    # staging on the host's
    pin = [torch.empty((batch,) + p.shape[1:], dtype=torch.uint8, pin_memory=True) for p in planes]
    res = [t.to(dev) for t in pin]
    outs = engine.process_batch_device(*res)
    pin_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
    ms_h2d = cuda_ms(lambda: [t.to(dev, non_blocking=True) for t in pin], 10, 2)
    ms_d2h = cuda_ms(lambda: [h.copy_(o, non_blocking=True) for h, o in zip(pin_out, outs)], 10, 2)
    in_bytes, out_bytes = nbytes(*pin), nbytes(*pin_out)

    def stage():
        for t, p in zip(pin, planes):
            view = t.numpy()
            for i in range(batch):
                np.copyto(view[i], p[i])

    ms_stage = host_ms(stage, 10)
    ms_enqueue = host_ms(lambda: engine.process_batch_device(*res), 10)
    torch.cuda.synchronize()
    print(f"phase 16 a group of {batch} frames apart, on {card}: copy in {in_bytes / 1e6:.2f} MB "
          f"{ms_h2d:.3f} ms = {in_bytes / ms_h2d / 1e6:.2f} GB/s, copy out {out_bytes / 1e6:.2f} MB "
          f"{ms_d2h:.3f} ms = {out_bytes / ms_d2h / 1e6:.2f} GB/s (pinned, CUDA events); the "
          f"resident step {resident_ms:.3f} ms; on the host's clock: staging into pinned "
          f"memory {ms_stage:.3f} ms, enqueueing the step {ms_enqueue:.3f} ms")
    # the row's times: pass 1 over the stream's own stack
    stack = cheap_upscale(up.guard_band_stack(res[0].to(torch.float32), 6),
                          2 * (LR_H + 12) * batch, out_w, 8)
    skw = dict(kw, **edges[0], blending=2, frame_h=out_h, frame_pad=12)
    ms = cuda_ms(lambda: fk.raisr_pass_full(stack, filters[0], **skw), 10, 2)
    ms_plain = cuda_ms(lambda: fk.raisr_pass_full_reference(stack, filters[0], **skw), 2)
    row = kernel_row("full_kernel_stream", "raisr_tpu_torch/csrc/full_kernel.cu",
                     "raisr_tpu/ops/pallas/full_kernel.py:82", launches, errs, ms, ms_plain,
                     pass_bound(stack, filters[0]))
    return row, dict(folder=folder, frames=frames, want=want, rates=rates)


def cli_lines(argv, phase: int = 17) -> list[str]:
    """Run the port's CLI in process; returns what it printed on stdout."""
    import contextlib
    import io

    from raisr_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"phase {phase} failed: raisr-torch {' '.join(argv)} returned {rc}")
    return buf.getvalue().strip().splitlines()


def run_cli(card: str, tmp: str, c16: dict) -> None:
    """Phase 17: `raisr-torch upscale` file to file on the card (no --device:
    cuda is the default), on phase 16's frames as a Y4M clip and phase 16's
    folder; the output read back with Y4MReader must be 3840x2160, 24 frames,
    each equal to phase 16's; then compare, info and both bench forms."""
    from raisr_tpu_torch import video
    from raisr_tpu_torch.ops.cuda import full_kernel as fk

    src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.y4m")
    write_y4m(src, c16["frames"])
    folder = c16["folder"]
    zero(fk.LAUNCHES)
    fk.EPILOGUE_LAUNCHES = 0
    glue_zero()
    lines = cli_lines(["upscale", "-i", src, "-o", dst, "--passes", str(PASSES), "--batch", "4",
                       "--filterfolder", folder])
    launches = (fk.LAUNCHES[("float32", 4)], fk.EPILOGUE_LAUNCHES)
    glue_read("17")
    rd = video.Y4MReader(dst)
    got = list(rd)
    rd.close()
    same = frames_equal(got, c16["want"])
    print(f"phase 17 raisr-torch upscale on {card}: {lines[-1]} (the CLI's own clock: it "
          f"includes reading {os.path.getsize(src) / 1e6:.1f} MB and writing "
          f"{os.path.getsize(dst) / 1e6:.1f} MB of Y4M); output {rd.fmt.width}x{rd.fmt.height}, "
          f"{len(got)} frames, equal to phase 16's bit for bit: {same}; fused passes "
          f"launched {launches[0]} (launch B {launches[1]})")
    if (not same or (rd.fmt.width, rd.fmt.height, len(got)) != (2 * LR_W, 2 * LR_H, 24)
            or launches != (PASSES * 6,) * 2):
        raise SystemExit("phase 17 failed: the upscaled clip or the launch count")
    cmp = json.loads(cli_lines(["compare", dst, dst, "--frames", "4"])[-1])
    print(f"phase 17 raisr-torch compare of the output with itself: {json.dumps(cmp)}")
    if cmp["psnr_y_db"] != float("inf") or cmp["frames"] != 4:
        raise SystemExit("phase 17 failed: compare")
    info = json.loads("\n".join(cli_lines(["info", "--filterfolder", folder, "--passes",
                                           str(PASSES)])))
    print(f"phase 17 raisr-torch info: qangle {info['qangle']}, passes {info['passes']}, "
          f"bank {info['banks'][0]['hashkey_size']}x{info['banks'][0]['pixel_types']}x"
          f"{info['banks'][0]['taps']}")
    if (info["passes"], info["banks"][0]["hashkey_size"], info["banks"][0]["taps"]) != (
            PASSES, 216, 121):
        raise SystemExit("phase 17 failed: info")
    common = ["--passes", str(PASSES), "--filterfolder", folder]
    for argv in (["bench", "--frames", "20"], ["bench", "--latency", "--frames", "20"]):
        line = cli_lines(argv + common)[-1]
        json.loads(line)
        print(f"phase 17 raisr-torch {' '.join(argv)} on {card}: {line}")


def run_modes(y, u, v, dev, card: str, model, kw: dict) -> None:
    """Phase 18: the cubic and lanczos resize on the card against the same
    function on the CPU (a 1080p plane at 2x and 1.5x; the sum of each axis
    is the same chain of float32 products and sums on both, so 0); one 1080p
    frame through the fused engine with resize_mode="cubic" against the
    plain passes, bit for bit; one 1080p frame, 1 pass, backend="xla" (the
    dense convolution, with TF32 switched on globally around it: the call
    itself must turn it off) against backend="reference" within the fuzz
    bar."""
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.resize import cheap_upscale

    plane = y[0].to(torch.float32)
    for mode in ("cubic", "lanczos"):
        for ratio in (2.0, 1.5):
            oh, ow = int(LR_H * ratio), int(LR_W * ratio)
            got = cheap_upscale(plane, oh, ow, 8, mode=mode)
            want = cheap_upscale(plane.cpu(), oh, ow, 8, mode=mode)
            frac, _, mx = diff_stats(got.cpu(), want)
            print(f"phase 18 cheap_upscale {mode} {LR_H}x{LR_W} -> {oh}x{ow}, card vs CPU: "
                  f"differing {frac:.6%}, max abs error {mx}")
            if mx != 0.0:
                raise SystemExit(f"phase 18 failed: {mode} at {ratio}x")
    cfg = RaisrConfig(passes=PASSES, resize_mode="cubic")
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    engine = RaisrEngine(cfg, model, device=dev)
    zero(fk.LAUNCHES)
    oy, ou, ov = engine.process_batch_device(y[:1], u[:1], v[:1])
    torch.cuda.synchronize()
    x = plane
    for p, b in enumerate(model.banks):
        cur = cheap_upscale(x, out_h, out_w, 8, mode="cubic") if p == 0 else x
        x = fk.raisr_pass_full_reference(
            cur, torch.tensor(b.filters, device=dev), blending=2,
            **dict(kw, qstr=tuple(float(q) for q in b.qstr), qcoh=tuple(float(q) for q in b.qcoh)))
    hold("18 cubic engine", f"Y of one frame vs the plain passes (launches "
         f"{fk.LAUNCHES[('float32', 4)]})", oy[0].to(torch.float32), x)
    uv_ok = all(torch.equal(g[0], pipeline.process_plane_uv(s[0], LR_H, LR_W, 8, "cubic")
                            .to(torch.uint8)) for g, s in ((ou, u), (ov, v)))
    if fk.LAUNCHES[("float32", 4)] != PASSES or not uv_ok:
        raise SystemExit("phase 18 failed: the cubic engine's launch count or U/V")

    engines = {b: RaisrEngine(RaisrConfig(passes=1, backend=b), model, device=dev)
               for b in ("xla", "reference")}
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = engines["xla"].process_batch_device(y[:1])[0]
        ms_conv = cuda_ms(lambda: engines["xla"].process_batch_device(y[:1]), 2, 0)
        still_on = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    taps = engines["reference"].process_batch_device(y[:1])[0]
    ms_taps = cuda_ms(lambda: engines["reference"].process_batch_device(y[:1]), 2, 0)
    frac, med, mx = diff_stats(conv, taps)
    print(f"phase 18 backend xla vs reference on {card}, one 1080p frame, 1 pass: differing "
          f"{frac:.6%}, median {med}, max {mx}; xla {ms_conv:.3f} ms, reference {ms_taps:.3f} "
          f"ms a frame; the caller's TF32 flag restored: {still_on}")
    if not (frac < FUZZ_MAX_FRAC and med == 0.0 and still_on):
        raise SystemExit("phase 18 failed: backend xla against reference")


def make_training_frames(n: int, h: int, w: int, seed: int, device) -> list:
    """n 8-bit HR frames with edges and texture in the video range the
    hold-out eval clamps to: make_patchwork's gratings in 32-pixel blocks
    averaged with make_planes' smooth noise, mapped to [16, 235], plus
    Gaussian noise of sigma 2; uint8 numpy planes."""
    import torch

    out = []
    for i in range(n):
        patch = make_patchwork(h, w, seed + i, device, blk=32)
        smooth = make_planes(1, h, w, seed + 100 + i, device)[0].to(torch.float32)
        gen = torch.Generator(device=device).manual_seed(seed + 200 + i)
        noise = 2.0 * torch.randn((h, w), generator=gen, device=device)
        img = 16 + (0.5 * patch + 0.5 * (smooth - 16) * 255 / 219) * 219 / 255 + noise
        out.append(torch.clamp(torch.round(img), 16, 235).to(torch.uint8).cpu().numpy())
    return out


def onehot_accumulate(q, v, cheap, label, idx, n_chunks: int, chunk: int = ONEHOT_CHUNK):
    """raisr_tpu's _accumulate_chunked (train/trainer.py:119-147) as
    torch.matmul on the card, over the first n_chunks chunks of core pixels
    in raster order: each chunk's 11x11 patches (its im2col), the transpose
    of its [chunk, num_filters] one-hot matrix times the [chunk, 121 * 121]
    outer products into Q and times the label-weighted patches into V, in
    float32 (TF32 is off for the whole run)."""
    import torch

    from raisr_tpu_torch.ops.cuda import normal_eq as ne

    w, core_w, nf = cheap.shape[1], idx.shape[1], q.shape[0]
    offs = ne._tap_offsets(w, cheap.device)
    flat = idx.reshape(-1).to(torch.int64)
    filters = torch.arange(nf, device=cheap.device)
    for k in range(n_chunks):
        pos = torch.arange(k * chunk, min((k + 1) * chunk, flat.numel()), device=cheap.device)
        ctr = (pos // core_w + ne.CORE) * w + pos % core_w + ne.CORE
        p = cheap.reshape(-1)[ctr[:, None] + offs[None, :]]
        onehot = (flat[pos][:, None] == filters[None, :]).to(torch.float32)
        v += onehot.T @ (p * label.reshape(-1)[ctr][:, None])
        q += (onehot.T @ (p[:, :, None] * p[:, None, :]).reshape(len(pos), -1)).reshape(q.shape)


def training_split(fn, calls: int = 1) -> str:
    """Where the time of `calls` calls of a training function goes, a call
    at a time: a torch.profiler trace (after one untraced call) gives the
    wall time on the host's clock, the device's busy time (the union of its
    kernels' intervals) and the device time by kernel group (`_kernel_group`:
    the normal-equation kernel's two launches, the sort of its glue, and
    PyTorch's elementwise kernels: the 2-D hash, the resize, the planes'
    arithmetic)."""
    with tempfile.TemporaryDirectory() as tmp:
        kernels, marks = trace(fn, calls, os.path.join(tmp, "train.json"))
    t0 = min(float(e["ts"]) for e in marks)
    wall = max(float(e["ts"]) + float(e["dur"]) for e in marks + kernels) - t0
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    parts = ", ".join(f"{g} {us / calls / 1000:.4f}" for g, us in
                      sorted(kernel_groups(kernels).items(), key=lambda kv: -kv[1]))
    return (f"wall {wall / calls / 1000:.3f} ms, device busy {busy / calls / 1000:.3f} ms "
            f"({100 * busy / wall:.1f}%), {len(kernels) / calls:g} kernels; device ms: {parts}")


def run_train(dev, card: str, tmp: str, kw: dict) -> dict:
    """Phase 20: filter training on the card through `raisr-torch train` (no
    --device: cuda is the default) on a Y4M clip of TRAIN_FRAMES seeded 1080p
    HR frames, the 8th held out: 2x with 2 passes and --ct-refine (blending
    2), then 1.5x with 1 pass; each run's launches of the accumulation kernel,
    apply_filters and launch B against what the path makes, and its hold-out
    report. Then, on one 1080p pair, the kernel against its plain version
    accumulated in float64 (plain and weighted), twice for determinism, the
    banks solved from both, and its pixel counts exactly; the path's other
    kernels on the path's own inputs (apply_filters on the CT sweep's
    provisional plane and on pass 2's input, launch B on pass 2's input, the
    1.5x fused pass on the held-out frame), bit for bit against their plain
    versions; the times; the trained 2x bank served from its folder (4 frames
    through process_batch_device) against the plain passes and the taps
    engine, and the bf16 and int8 tiers beside float32 on it. Returns the
    kernel's `kernels` row, the errors of the other kernels by the name of
    their rows, and the HR frames."""
    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine, load_model
    from raisr_tpu_torch.engine import Frame
    from raisr_tpu_torch.ops import census
    from raisr_tpu_torch.ops.cuda import filter_kernel as flk
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
    from raisr_tpu_torch.ops.pipeline import pass_statics
    from raisr_tpu_torch.ops.resize import cheap_upscale
    from raisr_tpu_torch.train import trainer as tr

    h, w = LR_H, LR_W  # 1080p HR frames; the 2x LR frames are 540x960
    hrs = make_training_frames(TRAIN_FRAMES, h, w, 20, dev)
    chroma = np.full((h // 2, w // 2), 128, np.uint8)
    clip = os.path.join(tmp, "train_hr.y4m")
    write_y4m(clip, [Frame(y=x, u=chroma, v=chroma) for x in hrs])
    n_train = TRAIN_FRAMES - 1

    def train(tag: str, argv: list, want: dict):
        zero(fk.LAUNCHES)
        fk.EPILOGUE_LAUNCHES = flk.LAUNCHES = flk.SINGLE_LAUNCHES = ne.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = cli_lines(["train", "-i", clip, "--eval-holdout", str(TRAIN_FRAMES), *argv],
                          phase=20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(normal_eq=ne.LAUNCHES, apply_filters=flk.LAUNCHES + flk.SINGLE_LAUNCHES,
                      pass_epilogue=fk.EPILOGUE_LAUNCHES, fused_passes=sum(fk.LAUNCHES.values()))
        report = json.loads(next(x for x in reversed(lines) if x.startswith('{"eval"')))["eval"]
        sweeps = want["normal_eq"] // n_train
        print(f"phase 20 raisr-torch train {tag} on {card}: {n_train} training frames {w}x{h} "
              f"and 1 held out, {wall:.3f} s wall = {wall / sweeps:.3f} s a sweep ({sweeps} "
              f"sweeps; reading the clip and the hold-out eval included); launches {counts}, "
              f"expected {want}; hold-out {json.dumps(report)}")
        if counts != want:
            raise SystemExit(f"phase 20 failed: {tag} launch counts")
        if not (report["holdout_frames"] == 1
                and report["trained_psnr_db"] > report["bilinear_psnr_db"] > 0):
            raise SystemExit(f"phase 20 failed: {tag} hold-out report")
        return counts["normal_eq"], wall / sweeps

    bank2 = os.path.join(tmp, "trained_2x")
    # sweeps: plain, CT-weighted (apply_filters on the provisional bank) and
    # pass 2 (apply_filters and launch B for the pass-1 output); the held-out
    # frame is served by two fused passes (each with its launch B)
    launches, sweep_s = train("2x, 2 passes, --ct-refine (blending 2)",
                              ["-o", bank2, "--passes", "2", "--ct-refine", "--blending", "2"],
                              dict(normal_eq=3 * n_train, apply_filters=2 * n_train,
                                   pass_epilogue=n_train + 2, fused_passes=2))
    bank15 = os.path.join(tmp, "trained_15x")
    launches15, _ = train("1.5x, 1 pass", ["-o", bank15, "--ratio", "1.5"],
                          dict(normal_eq=n_train, apply_filters=0, pass_epilogue=1,
                               fused_passes=1))

    # -- the kernel against its plain version, on one 1080p pair -----------
    cfg = tr.TrainConfig()
    lr, hr = tr.degrade(hrs[0], 2.0, 8)
    hr_t = torch.tensor(hr.astype(np.float32), device=dev)
    cheap = cheap_upscale(torch.tensor(lr.astype(np.float32), device=dev), h, w, 8)
    buckets, idx = tr._filter_index(cheap, cfg)
    s = census.randomness_weight(cheap).contiguous()
    errs = []
    for name, label, weight in (("plain", hr_t, None),
                                ("weighted (Randomness s)",
                                 (hr_t - (1.0 - s) * cheap).contiguous(), s)):
        q, v = tr.init_accumulators(cfg, dev)
        ne.accumulate_normal_eq(q, v, cheap, label, idx, weight)
        q2, v2 = tr.init_accumulators(cfg, dev)
        ne.accumulate_normal_eq(q2, v2, cheap, label, idx, weight)
        q64 = torch.zeros(q.shape, dtype=torch.float64, device=dev)
        v64 = torch.zeros(v.shape, dtype=torch.float64, device=dev)
        ne.normal_eq_reference(q64, v64, cheap, label, idx, weight)
        torch.cuda.synchronize()
        dq, dv = (q.double() - q64).abs(), (v.double() - v64).abs()

        def rel(d, ref, dims):
            top = ref.abs().amax(dim=dims)
            return float(torch.where(top > 0, d.amax(dim=dims) / top, d.amax(dim=dims)).max())

        rel_q, rel_v = rel(dq, q64, (1, 2)), rel(dv, v64, 1)
        same = torch.equal(q, q2) and torch.equal(v, v2)
        bank_k = tr.solve_filters(q, v, cfg)
        bank_p = tr.solve_filters(q64.to(torch.float32), v64.to(torch.float32), cfg)
        bank_ok = torch.allclose(bank_k, bank_p, rtol=2e-3, atol=2e-4)
        print(f"phase 20 normal_eq vs plain (float64) on one {w}x{h} pair, {name}: "
              f"{idx.numel()} core pixels in {int(torch.unique(idx).numel())} filters; max "
              f"|dQ_f| / max|Q_f| {rel_q:.3e}, max |dV_f| / max|V_f| {rel_v:.3e} (bound "
              f"{NORMAL_EQ_MAX_REL_ERR:g}); max |dQ| {float(dq.max()):.6g}, |dV| "
              f"{float(dv.max()):.6g}; two runs bit-identical: {same}; solved banks max diff "
              f"{float((bank_k - bank_p).abs().max()):.3e} (rtol 2e-3, atol 2e-4): {bank_ok}")
        if not (bool(torch.isfinite(q).all()) and rel_q <= NORMAL_EQ_MAX_REL_ERR
                and rel_v <= NORMAL_EQ_MAX_REL_ERR and same and bank_ok):
            raise SystemExit(f"phase 20 failed: normal_eq against its plain version, {name}")
        errs.append(max(float(dq.max()), float(dv.max())))
    # every core pixel counted once, in its own filter: on a plane of ones
    # each entry of Q[f] is f's pixel count, and V[f] the sum over f's pixels
    # of an integer label in [0, 7), both exact (integers below 2^24)
    nf = cfg.num_filters
    lab = (torch.arange(h * w, device=dev) % 7).reshape(h, w).to(torch.float32)
    qc, vc = tr.init_accumulators(cfg, dev)
    ne.accumulate_normal_eq(qc, vc, torch.ones_like(cheap), lab, idx)
    flat = idx.reshape(-1).to(torch.int64)
    count = torch.bincount(flat, minlength=nf).to(torch.float64)
    lsum = torch.zeros(nf, dtype=torch.float64, device=dev).index_add_(
        0, flat, lab[ne.CORE: h - ne.CORE, ne.CORE: w - ne.CORE].reshape(-1).double())
    count_err = max(float((qc.double() - count[:, None, None]).abs().max()),
                    float((vc.double() - lsum[:, None]).abs().max()))
    print(f"phase 20 normal_eq pixel counts on a plane of ones, one {w}x{h} pair: Q[f] vs "
          f"bincount(idx) and V[f] vs the label's sum per filter, max abs error {count_err} "
          f"(largest count {int(count.max())})")
    if count_err != 0.0:
        raise SystemExit("phase 20 failed: normal_eq's pixel counts")

    # -- the path's other kernels, on the path's own inputs ------------------
    # the CT sweep's provisional plane: the 2-D hash's int32 buckets and the
    # plain sweep's bank (the traced sweep below is that sweep: the CLI's
    # train_filterbank on the same pairs)
    pairs = [tr.degrade(x, 2.0, 8) for x in hrs[:n_train]]
    sweep = {}
    split_sweep = training_split(
        lambda: sweep.update(bank=tr.train_filterbank(pairs, cfg, dev)))
    f0 = torch.tensor(sweep["bank"].filters, device=dev)
    akw = dict(patch_size=cfg.patch_size, pixel_types=cfg.pixel_types,
               patch_margin=cfg.patch_size // 2, ratio=int(cfg.ratio))
    held = {"filter_kernel": [hold(
        "20 apply_filters", f"the CT sweep's provisional plane, one {w}x{h} pair, sweep 1's "
        f"bank", flk.apply_filters(cheap, buckets, f0, **akw),
        flk.apply_filters_reference(cheap, buckets, f0, **akw))]}
    # pass 2's input: the taps pass of the trained pass-1 bank with the
    # statics of RaisrConfig(ratio 2, passes 1)
    rcfg = RaisrConfig(filterfolder=bank2, passes=2)
    model = load_model(bank2, rcfg)
    st = pass_statics(RaisrConfig(ratio=2.0, passes=1), model, "taps")
    b1 = tr._hash(cheap, st.patch_size, st.bits, *st.bank_edges[0], st.qangle, st.qstrength,
                  st.qcoherence)
    f1 = torch.tensor(model.banks[0].filters, device=dev)
    akw1 = dict(patch_size=st.patch_size, pixel_types=4 if st.use_pixel_type else 1,
                patch_margin=st.patch_margin, ratio=st.ratio_int)
    raw1 = flk.apply_filters(cheap, b1, f1, **akw1)
    held["filter_kernel"].append(hold(
        "20 apply_filters", f"pass 2's input, one {w}x{h} pair, the trained pass-1 bank", raw1,
        flk.apply_filters_reference(cheap, b1, f1, **akw1)))
    lm = st.patch_size // 2 + 1
    held["full_kernel_epilogue"] = [hold(
        "20 launch B", f"pass 2's input, one {w}x{h} pair (min {st.min_val}, max {st.max_val}, "
        f"blending {st.blending}, exact edges {st.exact_edges})",
        fk.pass_epilogue(cheap, raw1, min_val=st.min_val, max_val=st.max_val,
                         blending=st.blending, patch_size=st.patch_size,
                         exact_edges=st.exact_edges),
        _finish_pass(cheap, raw1, min_val=st.min_val, max_val=st.max_val, blending=st.blending,
                     loop_margin=lm, col_end=processed_col_end(w, lm, st.exact_edges)))]
    # the 1.5x hold-out eval: one fused single-phase pass on the held-out
    # frame's bilinear upscale, with the trained 1.5x bank
    lr15, hr15 = tr.degrade(hrs[-1], 1.5, 8)
    cheap15 = cheap_upscale(torch.tensor(lr15.astype(np.float32), device=dev), *hr15.shape, 8)
    b15 = load_model(bank15, RaisrConfig(filterfolder=bank15, ratio=1.5, passes=1)).banks[0]
    f15 = torch.tensor(b15.filters, device=dev)
    kw15 = dict(kw, blending=2, qstr=tuple(float(e) for e in b15.qstr),
                qcoh=tuple(float(e) for e in b15.qcoh))
    held["full_kernel_single"] = [hold(
        "20 fused 1.5x pass", f"the held-out frame, {lr15.shape[1]}x{lr15.shape[0]} -> "
        f"{hr15.shape[1]}x{hr15.shape[0]}, "
        f"the trained 1.5x bank", fk.raisr_pass_full(cheap15, f15, pixel_types=1, **kw15),
        fk.raisr_pass_full_reference(cheap15, f15, pixel_types=1, **kw15))]

    # -- times ------------------------------------------------------------------
    ms = cuda_ms(lambda: ne.accumulate_normal_eq(q, v, cheap, hr_t, idx), 10, 2)
    ms_plain = cuda_ms(lambda: ne.normal_eq_reference(q, v, cheap, hr_t, idx), 1, 0)
    n_chunks = -(-idx.numel() // ONEHOT_CHUNK)
    ms_onehot = cuda_ms(lambda: onehot_accumulate(q, v, cheap, hr_t, idx, n_chunks), 1, 0)
    ops = 2 * NORMAL_EQ_MACS * idx.numel()
    bnd = bound(nbytes(cheap, hr_t, idx, q, v), nbytes(q, v), ops, "float32")
    print(f"phase 20 one plain 2x sweep (train_filterbank, {n_train} pairs from host memory) "
          f"on {card}: {split_sweep}")
    split = training_split(lambda: ne.accumulate_normal_eq(q, v, cheap, hr_t, idx), 5)
    print(f"phase 20 times on {card}, one {w}x{h} pair: normal_eq {ms:.3f} ms (the wrapper's "
          f"time: sort and run tables included; a call traced: {split}), "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: {ops / 1e9:.2f} GFLOP at 67 "
          f"TFLOP/s), plain {ms_plain:.3f} ms; the one-hot torch.matmul form "
          f"(_accumulate_chunked) over all {n_chunks} chunks of {ONEHOT_CHUNK}: "
          f"{ms_onehot:.3f} ms = {ms_onehot / ms:.1f}x the kernel; the 2x training run "
          f"{sweep_s:.3f} s a sweep of {n_train} frames")

    # -- serving the trained bank -------------------------------------------
    y4 = torch.stack([torch.tensor(tr.degrade(x, 2.0, 8)[0].astype(np.uint8))
                      for x in hrs[:4]]).to(dev)
    engine = RaisrEngine(rcfg, model, device=dev)
    zero(fk.LAUNCHES)
    glue_zero()
    oy = engine.process_batch_device(y4)[0]
    torch.cuda.synchronize()
    glue_read("20")
    print(f"phase 20 the trained 2x bank served from its folder: Y {tuple(oy.shape)} {oy.dtype}, "
          f"fused passes {fk.LAUNCHES[('float32', 4)]}")
    if tuple(oy.shape) != (4, h, w) or fk.LAUNCHES[("float32", 4)] != 2:
        raise SystemExit("phase 20 failed: serving the trained bank")
    filters = [torch.tensor(b.filters, device=dev) for b in model.banks]
    taps = RaisrEngine(RaisrConfig(filterfolder=bank2, passes=2, backend="reference"), model,
                       device=dev)
    for i in range(4):
        x = y4[i].to(torch.float32)
        for p, b in enumerate(model.banks):
            cur = cheap_upscale(x, h, w, 8) if p == 0 else x
            x = fk.raisr_pass_full_reference(
                cur, filters[p], blending=2, **dict(kw, qstr=tuple(float(e) for e in b.qstr),
                                                    qcoh=tuple(float(e) for e in b.qcoh)))
        frac, med, mx = diff_stats(oy[i], x)
        tfrac, tmed, tmx = diff_stats(oy[i], taps.upscale_y(y4[i].to(torch.float32)))
        print(f"phase 20 served frame {i}: vs plain passes differing {frac:.6%}, max {mx}; vs "
              f"taps engine differing {tfrac:.6%}, median {tmed}, max {tmx}")
        if mx > KERNEL_MAX_ABS_ERR or not (tfrac < FUZZ_MAX_FRAC and tmed == 0.0):
            raise SystemExit(f"phase 20 failed: served frame {i}")
    hr4 = torch.tensor(np.stack([tr.degrade(x, 2.0, 8)[1] for x in hrs[:4]]).astype(np.float32),
                       device=dev)
    bilinear = cheap_upscale(y4.to(torch.float32), h, w, 8)
    quality = [f"float32 {psnr(oy, hr4):.3f} dB", f"bilinear {psnr(bilinear, hr4):.3f} dB"]
    for dtype in ("auto", "int8"):
        other = RaisrEngine(RaisrConfig(filterfolder=bank2, passes=2, dtype=dtype), model,
                            device=dev).process_batch_device(y4)[0]
        frac, med, mx = diff_stats(other, oy)
        quality.append(f"{dtype} {psnr(other, hr4):.3f} dB (vs float32: differing {frac:.4%}, "
                       f"median {med}, max {mx})")
    print(f"phase 20 PSNR against HR of the 4 served (training) frames: {'; '.join(quality)}")
    return kernel_row("normal_eq", "raisr_tpu_torch/csrc/normal_eq.cu",
                      "raisr_tpu/train/trainer.py:119 (_accumulate_chunked, XLA's one-hot "
                      "contraction; no Pallas kernel)", launches + launches15, errs, ms,
                      ms_plain, bnd, ms_onehot), held, hrs


def enqueue_ms(fn, iters: int, warmup: int = 1) -> tuple[float, float]:
    """One call's device time (cuda_ms's event pair) and the host's time to
    enqueue it (the same loop on the host's clock, before waiting): where
    the second is the larger, the host sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def run_shard(dev, card: str, engine, y, want: dict, kw: dict, edges, filters, c15: dict,
              hrs) -> tuple[dict, dict]:
    """Phase 21: the multi-device paths over a mesh that names the one card
    several times (make_mesh(devices=[dev] * n)); each shard's work runs in
    turn on the card, with real halo copies. Stripe launches of the fused
    pass (the first and an interior stripe of pass 1 at 2x, one 1.5x stripe,
    from the striped resize) against the plain version; the sharded runs,
    each with the launch counts set to 0 just before it and read just
    after, against the unsharded outputs of the earlier phases bit for bit;
    the engine's refusal of a 2-device spec on one card; train_step_sharded
    over data 4 on phase 20's 8 frames, plain and CT-weighted, against
    one-device training; the times of the sharded steps beside the
    unsharded one, and a fixed batch at mesh sizes 1, 2 and 4. Returns this
    phase's launches and hold errors by the name of their `kernels` rows."""
    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine, RaisrError
    from raisr_tpu_torch.ops.cuda import filter_kernel as flk
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.parallel import make_mesh
    from raisr_tpu_torch.parallel import sharding as sh
    from raisr_tpu_torch.train import trainer as tr

    yf = y.to(torch.float32)
    out_h, out_w = 2 * LR_H, 2 * LR_W
    launches: dict[str, int] = {}
    errs: dict[str, list] = {"full_kernel": [], "full_kernel_single": []}

    def grid(data: int, rows: int):
        return sh.Mesh(np.array([dev] * (data * rows), dtype=object).reshape(data, rows),
                       ("data", "rows"))

    # -- stripe launches against the plain version -----------------------------
    for tag, row, (oh, ow), n, bank, bkw, pt in (
            ("2x", "full_kernel", (out_h, out_w), 4, filters[0], dict(kw, **edges[0]), 4),
            ("1.5x", "full_kernel_single", tuple(c15["cheap"].shape), 2, c15["filters"],
             c15["kw"], 1)):
        lr_halo, hs = sh._lr_halo(LR_H, oh), oh // n
        ext = sh._exchange_halo(sh._scatter(yf[0], [dev] * n), lr_halo)
        for idx in ((0, 1) if tag == "2x" else (1,)):
            cheap = sh._upscale_stripe(ext[idx], lr_halo, hs, sh.HR_HALO, ow, oh, 8, LR_H, idx,
                                       LR_H // n)
            pkw = dict(bkw, blending=2, row0=idx * hs - sh.HR_HALO, zone_h=oh, pixel_types=pt)
            errs[row].append(hold(
                f"21 {tag} stripe", f"stripe {idx} of {n}, pass 1, {tuple(cheap.shape)} (row0 "
                f"{pkw['row0']}, zone_h {oh})", fk.raisr_pass_full(cheap, bank, **pkw),
                fk.raisr_pass_full_reference(cheap, bank, **pkw)))

    # -- the sharded runs against the unsharded outputs --------------------------
    def drive(label, fn, expect, row, key, n_launch):
        torch.cuda.synchronize()
        zero(fk.LAUNCHES)
        fk.EPILOGUE_LAUNCHES = 0
        glue_zero()
        got = fn()
        torch.cuda.synchronize()
        glue_read("21")
        counts = {k: c for k, c in fk.LAUNCHES.items() if c}
        same = got.device == dev and torch.equal(got, expect.to(torch.float32))
        print(f"phase 21 {label}: Y {tuple(got.shape)} on {got.device}, equal to the unsharded "
              f"output bit for bit: {same}; fused passes {counts}, launch B "
              f"{fk.EPILOGUE_LAUNCHES} (expected {n_launch} of {key})")
        if not same or counts != {key: n_launch} or fk.EPILOGUE_LAUNCHES != n_launch:
            raise SystemExit(f"phase 21 failed: {label}")
        launches[row] = launches.get(row, 0) + n_launch
        launches["full_kernel_epilogue"] = launches.get("full_kernel_epilogue", 0) + n_launch

    def striped(eng, passes, mode, oh, ow, mesh):
        return lambda: sh.process_batch_2d(yf, eng._banks, eng._statics, passes, mode, oh, ow,
                                           mesh)

    s, f32 = engine._statics, ("float32", 4)
    mesh2d = make_mesh(4, devices=[dev] * 4)
    print(f"phase 21 meshes on {card}: {mesh2d}")
    drive("process_batch_2d, data=2 rows=2, phase 2's 4 frames, 2 passes",
          striped(engine, PASSES, 1, out_h, out_w, mesh2d), want["2"], "full_kernel", f32,
          N_FRAMES * 2 * PASSES)
    drive("process_batch_dp, data=4, phase 2's 4 frames",
          lambda: sh.process_batch_dp(yf, engine._banks, s, PASSES, 1, out_h, out_w,
                                      grid(4, 1)), want["2"], "full_kernel", f32, 4 * PASSES)
    drive("process_plane_row_sharded, rows=4, phase 2's frame 0",
          lambda: sh.process_plane_row_sharded(yf[0], engine._banks, s, PASSES, 1, out_h,
                                               out_w, grid(1, 4)), want["2"][0],
          "full_kernel", f32, 4 * PASSES)
    e15 = RaisrEngine(RaisrConfig(ratio=1.5, passes=PASSES_15X), c15["model"], device=dev)
    drive("rows=2, 1.5x, 4 frames", striped(e15, PASSES_15X, 1, *c15["cheap"].shape, grid(1, 2)),
          want["7"], "full_kernel_single", ("float32", 1), N_FRAMES * 2 * PASSES_15X)
    for phase, label, cfg, row, key in (
            ("19", "mode 2", RaisrConfig(passes=PASSES, mode=2), "full_kernel_f32_8bit_mode2",
             f32),
            ("11", "auto (bf16)", RaisrConfig(passes=PASSES, dtype="auto"), "full_kernel_bf16",
             ("bfloat16", 4)),
            ("13", "int8", RaisrConfig(passes=PASSES, dtype="int8"), "full_kernel_int8_8bit",
             ("int8", 4))):
        eng = RaisrEngine(cfg, engine.model, device=dev)
        drive(f"rows=2, {label}, 4 frames (phase {phase}'s)",
              striped(eng, PASSES, cfg.two_pass_mode, out_h, out_w, grid(1, 2)), want[phase],
              row, key, N_FRAMES * 2 * PASSES)

    # -- the engine on one card ------------------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards == 1:
        try:
            RaisrEngine(RaisrConfig(passes=PASSES), engine.model, shard="data=2", device=dev)
            refusal = None
        except RaisrError as e:
            refusal = str(e)
        print(f"phase 21 RaisrEngine(shard='data=2') on one visible card: {refusal}")
        if not refusal or "needs 2 devices but only 1 are visible" not in refusal:
            raise SystemExit("phase 21 failed: the engine took a 2-device spec on one card")
    else:
        eng = RaisrEngine(RaisrConfig(passes=PASSES), engine.model, shard="data=2", device=dev)
        print(f"phase 21 RaisrEngine(shard='data=2') over {n_cards} visible cards: {eng._mesh}")

    # -- train_step_sharded over data 4 -------------------------------------------
    cfg_t = tr.TrainConfig()
    pairs = [tr.degrade(x, 2.0, 8) for x in hrs]
    lr_b = torch.tensor(np.stack([p[0] for p in pairs]).astype(np.float32), device=dev)
    hr_b = torch.tensor(np.stack([p[1] for p in pairs]).astype(np.float32), device=dev)
    tmesh = make_mesh(4, ("data",), devices=[dev] * 4)
    plain_bank = None
    for tag in ("plain", "CT-weighted (blending 2, the plain step's bank)"):
        ct = plain_bank
        torch.cuda.synchronize()
        ne.LAUNCHES = flk.LAUNCHES = 0
        bank = tr.train_step_sharded(lr_b, hr_b, cfg_t, tmesh, ct_filters=ct)
        torch.cuda.synchronize()
        n_ne, n_af = ne.LAUNCHES, flk.LAUNCHES
        same = torch.equal(bank, tr.train_step_sharded(lr_b, hr_b, cfg_t, tmesh, ct_filters=ct))
        if ct is None:
            one = torch.tensor(tr.train_filterbank(pairs, cfg_t, dev).filters, device=dev)
        else:
            q, v = tr.init_accumulators(cfg_t, dev)
            for lr_i, hr_i in zip(lr_b, hr_b):
                tr.accumulate_pair_ct(q, v, tr._cheap(lr_i, hr_i, cfg_t), hr_i, ct, cfg_t, 2)
            one = tr.solve_filters(q, v, cfg_t)
        close = torch.allclose(bank, one, rtol=2e-3, atol=2e-4)
        want_af = 0 if ct is None else len(pairs)
        print(f"phase 21 train_step_sharded {tag}, data=4 over phase 20's {len(pairs)} frames: "
              f"normal_eq {n_ne}, apply_filters {n_af} (expected {len(pairs)}, {want_af}); two "
              f"runs bit-identical: {same}; vs one device max diff "
              f"{float((bank - one).abs().max()):.3e} (rtol 2e-3, atol 2e-4): {close}")
        if not (same and close and n_ne == len(pairs) and n_af == want_af):
            raise SystemExit(f"phase 21 failed: train_step_sharded {tag}")
        launches["normal_eq"] = launches.get("normal_eq", 0) + n_ne
        launches["filter_kernel"] = launches.get("filter_kernel", 0) + n_af
        plain_bank = bank

    # -- times ---------------------------------------------------------------------
    def step(mesh):
        return striped(engine, PASSES, 1, out_h, out_w, mesh)

    def dp(n):
        return lambda: sh.process_batch_dp(yf, engine._banks, s, PASSES, 1, out_h, out_w,
                                           grid(n, 1))

    timed = [("unsharded process_batch_y", lambda: engine.process_batch_y(yf)),
             ("2-D data=2 rows=2", step(mesh2d)), ("DP data=4", dp(4)),
             ("rows=4", step(grid(1, 4)))]
    timed += [(f"rows={n}", step(grid(1, n))) for n in (1, 2)] + [
        (f"DP data={n}", dp(n)) for n in (1, 2)]
    parts = []
    for label, fn in timed:
        dev_ms, host = enqueue_ms(fn, 5)
        parts.append(f"{label} {dev_ms:.3f} ms (host enqueue {host:.3f})")
    pred = ", ".join(f"rows={n} {100 * 2 * sh.HR_HALO * n / out_h:.2f}%" for n in (1, 2, 4))
    print(f"phase 21 times on {card}, {N_FRAMES} frames 1080p -> 4K, 2 passes, Y only, one "
          f"card: {'; '.join(parts)}. Halo rows over stripe rows, the predicted extra work of "
          f"the stripes over the whole frame: {pred}")
    return launches, errs


class CFrame:
    """One frame in the caller's strided planes, as a C host hands them to
    RTPU_Process: each row `CAPI_ROW_PAD` bytes past its samples, and the
    output planes filled with a sentinel that no write past a row's width
    may touch."""

    def __init__(self, frame, out_sizes):
        import numpy as np

        def padded(shape, dtype, fill):
            return np.full((shape[0], shape[1] + CAPI_ROW_PAD // np.dtype(dtype).itemsize),
                           fill, dtype)

        self.frame = frame
        self.src = [frame.y, frame.u, frame.v]
        self.inp = [padded(p.shape, p.dtype, 0) for p in self.src]
        for buf, p in zip(self.inp, self.src):
            buf[:, :p.shape[1]] = p
        self.out_sizes = out_sizes
        self.out = [padded(s, frame.y.dtype, CAPI_SENTINEL) for s in out_sizes]

    def planes(self):
        """The six RTPUPlane pointers of RTPU_SetRes and RTPU_Process."""
        import ctypes

        from raisr_tpu_torch.native.build_capi import RTPUPlane

        shapes = [p.shape for p in self.src] + list(self.out_sizes)
        return [ctypes.byref(RTPUPlane(b.ctypes.data, s[1], s[0], b.strides[0]))
                for b, s in zip(self.inp + self.out, shapes)]

    def got(self):
        """The output planes, or None if a byte past a row's width changed."""
        if any((b[:, s[1]:] != CAPI_SENTINEL).any() for b, s in zip(self.out, self.out_sizes)):
            return None
        return [b[:, :s[1]] for b, s in zip(self.out, self.out_sizes)]


def frame_err(got, want) -> float:
    """Largest absolute difference of a C ABI output to engine.process's
    frame, over Y, U and V; inf when a write past a row's width was seen."""
    import numpy as np

    if got is None:
        return float("inf")
    return max(float(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())
               for g, w in zip(got, (want.y, want.u, want.v)))


def run_capi(dev, card: str, tmp: str, ms_step: float) -> tuple[dict, dict]:
    """Phase 22: the C ABI (include/raisr_tpu.h) over the port. Builds
    build/capi_torch/libraisr_tpu.so, capi_smoke and capi_y4m from the
    checkout and loads the library into this interpreter with ctypes, so
    the bridge runs here and the launch counts count. RTPU_SetDevice(0),
    then RTPU_InitEx at 2x, 8 bits, 2 passes for tiers 0, 1 and 2 on a
    folder of phase 16's bank (seed 16), RTPU_SetRes and RTPU_Process over 4 frames of 1080p
    YUV420 in strided planes (each row 64 bytes past its samples, in and
    out): every output equal to engine.process of the frame at the tier,
    bit for bit, the tier's fused launches exactly frames x passes; both
    blendings (the second blending's engine built once); one 10-bit 2x
    float32 frame and one 1.5x frame (the seed-15 single-phase bank);
    RTPU_Process from a second host thread within 60 s, with the main
    thread's bytes; capi_y4m on a Y4M of 8 seeded 1080p frames
    byte-identical to `raisr-torch upscale` of the same clip and folder,
    and capi_smoke exiting 0; the error codes of a card index out of range,
    a missing folder and Process after Deinit. Prints Init's time, ms per
    RTPU_Process beside engine.process and phase 4's per-frame share of the
    batched step (`ms_step` for N_FRAMES frames), and capi_y4m's frames/s
    beside the CLI's, all on the host's clock. Returns the launches and the
    errors of the path by `kernels` row."""
    import sysconfig
    import threading

    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine, capi_bridge
    from raisr_tpu_torch.engine import Frame
    from raisr_tpu_torch.native import build_capi
    from raisr_tpu_torch.ops.cuda import full_kernel as fk

    t0 = time.perf_counter()
    lib = build_capi.load()
    print(f"phase 22 build: {build_capi.BUILD_DIR.name}/{build_capi.LIB_NAME}, "
          f"{', '.join(build_capi.TOOLS)} in {time.perf_counter() - t0:.1f} s; Python "
          f"{sysconfig.get_config_var('LDLIBRARY')} (shared: "
          f"{sysconfig.get_config_var('Py_ENABLE_SHARED')}); RTPU_Version "
          f"{lib.RTPU_Version().decode()}")
    launches: dict[str, int] = {}
    errs: dict[str, list] = {}

    def fail(what: str):
        raise SystemExit(f"phase 22 failed: {what}")

    def host_frames(n: int, seed: int, bits: int = 8) -> list:
        planes = [make_planes(n, h, w, seed + k, dev, bits).cpu().numpy()
                  for k, (h, w) in enumerate(((LR_H, LR_W), (LR_H // 2, LR_W // 2),
                                              (LR_H // 2, LR_W // 2)))]
        return [Frame(y=planes[0][i], u=planes[1][i], v=planes[2][i]) for i in range(n)]

    def c_frame(fr: Frame, cfg) -> CFrame:
        ch, cw = cfg.output_size(*fr.u.shape)
        return CFrame(fr, [cfg.output_size(*fr.y.shape), (ch, cw), (ch, cw)])

    def init(folder: str, ratio: float, bits: int, passes: int, tier: int) -> float:
        t = time.perf_counter()
        rc = lib.RTPU_InitEx(folder.encode(), ratio, bits, 0, passes, 1, tier)
        if rc != 0:
            fail(f"RTPU_InitEx({folder}, {ratio}, {bits}, passes {passes}, tier {tier}) "
                 f"returned {rc}")
        return (time.perf_counter() - t) * 1e3

    def drive(label, cfs, key, row, n_launch, blending=2):
        """RTPU_Process over `cfs` with the counts set to 0 just before;
        the fused launches must be exactly n_launch of form `key`."""
        torch.cuda.synchronize()
        zero(fk.LAUNCHES)
        fk.EPILOGUE_LAUNCHES = 0
        glue_zero()
        for cf in cfs:
            rc = lib.RTPU_Process(*cf.planes(), blending)
            if rc != 0:
                fail(f"{label}: RTPU_Process returned {rc}")
        counts, b = dict(fk.LAUNCHES), fk.EPILOGUE_LAUNCHES
        glue_read("22")
        print(f"phase 22 {label}: {len(cfs)} frames through RTPU_Process, fused launches "
              f"{counts}, launch B {b}")
        if counts.get(key) != n_launch or sum(counts.values()) != n_launch or b != n_launch:
            fail(f"{label}: launch count")
        launches[row] = launches.get(row, 0) + n_launch
        launches["full_kernel_epilogue"] = launches.get("full_kernel_epilogue", 0) + b

    def check(label, cfs, ref, row):
        for i, cf in enumerate(cfs):
            err = frame_err(cf.got(), ref.process(cf.frame))
            errs.setdefault(row, []).append(err)
            if err > KERNEL_MAX_ABS_ERR:
                fail(f"{label}: frame {i} differs from engine.process (max {err})")
        print(f"phase 22 {label}: Y/U/V of every frame equal to engine.process bit for bit, "
              f"nothing written past a row's width")

    folder = os.path.join(tmp, "bank")
    model = make_bank(folder, seed=16)
    frames = host_frames(N_FRAMES, 221)
    if lib.RTPU_SetDevice(0) != 0:
        fail("RTPU_SetDevice(0)")
    times = {}
    for tier, dtype, row in ((0, "float32", "full_kernel"), (1, "bfloat16", "full_kernel_bf16"),
                             (2, "int8", "full_kernel_int8_8bit")):
        init_ms = init(folder, 2.0, 8, PASSES, tier)
        eng = capi_bridge._engine
        if (eng.device != dev or eng.cfg.dtype != dtype or eng._statics.tier != dtype
                or eng._backend != "pallas"):
            fail(f"tier {tier}: engine on {eng.device}, dtype {eng.cfg.dtype}, tier "
                 f"{eng._statics.tier}, backend {eng._backend}")
        cfg = RaisrConfig(filterfolder=folder, passes=PASSES, dtype=dtype)
        ref = RaisrEngine(cfg, model, device=dev)
        cfs = [c_frame(fr, cfg) for fr in frames]
        if lib.RTPU_SetRes(*cfs[0].planes()) != 0:
            fail("RTPU_SetRes")
        label = f"2x 8-bit {PASSES}-pass tier {tier} ({dtype})"
        drive(label, cfs, (dtype, 4), row, N_FRAMES * PASSES)
        check(label, cfs, ref, row)
        ms_capi = host_ms(lambda: lib.RTPU_Process(*cfs[0].planes(), 2), 10)
        ms_eng = host_ms(lambda: ref.process(frames[0]), 10)
        times[dtype] = (init_ms, ms_capi, ms_eng)
        if tier == 0:
            # the other blending: its engine built once, from the same model
            ref1 = RaisrEngine(RaisrConfig(filterfolder=folder, passes=PASSES, blending=1),
                               model, device=dev)
            cf1 = [c_frame(frames[0], cfg), c_frame(frames[0], cfg)]
            drive("blending 1 (Randomness)", cf1[:1], (dtype, 4), row, PASSES, blending=1)
            eng1 = capi_bridge._engines_by_blend.get(1)
            drive("blending 1 again", cf1[1:], (dtype, 4), row, PASSES, blending=1)
            if (eng1 is None or capi_bridge._engines_by_blend.get(1) is not eng1
                    or eng1.model is not eng.model or len(capi_bridge._engines_by_blend) != 2):
                fail("the second blending's engine was not built once from the same model")
            check("blending 1 (Randomness)", cf1, ref1, row)
            first = cfs[0]
    # 10 bits: uint16 planes, 2x float32
    folder10 = os.path.join(tmp, "bank10")
    make_bank(folder10, bits=10, seed=16)
    init(folder10, 2.0, 10, PASSES, 0)
    cfg10 = RaisrConfig(filterfolder=folder10, bits=10, passes=PASSES)
    cf10 = [c_frame(fr, cfg10) for fr in host_frames(1, 224, bits=10)]
    drive("2x 10-bit (uint16) float32", cf10, ("float32", 4), "full_kernel_f32_10bit", PASSES)
    check("2x 10-bit (uint16) float32", cf10, RaisrEngine(cfg10, device=dev),
          "full_kernel_f32_10bit")
    # 1.5x: the single-phase bank
    folder15 = os.path.join(tmp, "bank15")
    make_bank(folder15, passes=PASSES_15X, pixel_types=1, ratio=1.5, seed=15)
    init(folder15, 1.5, 8, PASSES_15X, 0)
    cfg15 = RaisrConfig(filterfolder=folder15, ratio=1.5, passes=PASSES_15X)
    cf15 = [c_frame(frames[0], cfg15)]
    drive("1.5x 8-bit float32", cf15, ("float32", 1), "full_kernel_single", PASSES_15X)
    check("1.5x 8-bit float32", cf15, RaisrEngine(cfg15, device=dev), "full_kernel_single")

    # a second host thread: ctypes gives the GIL up, the library takes it back
    init(folder, 2.0, 8, PASSES, 0)
    second = c_frame(frames[0], RaisrConfig(passes=PASSES))
    rcs = []
    thread = threading.Thread(target=lambda: rcs.append(lib.RTPU_Process(*second.planes(), 2)),
                              daemon=True)
    t0 = time.perf_counter()
    thread.start()
    thread.join(60)
    ms_thread = (time.perf_counter() - t0) * 1e3
    got, want = second.got(), first.got()
    same = (not thread.is_alive() and rcs == [0] and got is not None
            and all(np.array_equal(a, b) for a, b in zip(got, want)))
    print(f"phase 22 RTPU_Process from a second host thread: returned {rcs} in "
          f"{ms_thread:.1f} ms, the main thread's bytes: {same}")
    if not same:
        fail("RTPU_Process from a second host thread")

    # C hosts: capi_y4m against the CLI, capi_smoke
    env = dict(os.environ, LD_LIBRARY_PATH=str(build_capi.BUILD_DIR))
    env.pop(capi_bridge.DEVICE_ENV, None)
    clip_frames = host_frames(8, 225)
    src = os.path.join(tmp, "capi_in.y4m")
    out_c, out_cli = os.path.join(tmp, "capi_out.y4m"), os.path.join(tmp, "cli_out.y4m")
    write_y4m(src, clip_frames)
    t0 = time.perf_counter()
    r = subprocess.run([str(build_capi.BUILD_DIR / "capi_y4m"), src, out_c, folder, "2", "8",
                        "0", str(PASSES), "1", "2"], capture_output=True, text=True,
                       timeout=600, env=env)
    s_capi = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"capi_y4m returned {r.returncode}: {r.stdout[-2000:]}{r.stderr[-2000:]}")
    t0 = time.perf_counter()
    lines = cli_lines(["upscale", "-i", src, "-o", out_cli, "--passes", str(PASSES),
                       "--filterfolder", folder], phase=22)
    s_cli = time.perf_counter() - t0
    with open(out_c, "rb") as a, open(out_cli, "rb") as b:
        same = a.read() == b.read()
    n = len(clip_frames)
    print(f"phase 22 capi_y4m on {card}: {r.stderr.strip().splitlines()[-1]}; {s_capi:.2f} s "
          f"= {n / s_capi:.2f} frames/s for the whole process (interpreter start, torch "
          f"import, Init and Y4M I/O included); raisr-torch upscale in process {s_cli:.2f} s "
          f"= {n / s_cli:.2f} frames/s ({lines[-1]}); byte-identical: {same}")
    if not same:
        fail("capi_y4m's output differs from raisr-torch upscale's")
    r = subprocess.run([str(build_capi.BUILD_DIR / "capi_smoke"), folder], capture_output=True,
                       text=True, timeout=600, env=env)
    print(f"phase 22 capi_smoke: exit {r.returncode}, {r.stdout.strip().splitlines()[-1:]}")
    if r.returncode != 0:
        fail(f"capi_smoke: {r.stdout[-2000:]}{r.stderr[-2000:]}")

    # error codes
    n_cards = torch.cuda.device_count()
    codes = [lib.RTPU_SetDevice(n_cards),
             lib.RTPU_InitEx(folder.encode(), 2.0, 8, 0, PASSES, 1, 0),
             lib.RTPU_SetDevice(0),
             lib.RTPU_InitEx(os.path.join(tmp, "missing").encode(), 2.0, 8, 0, PASSES, 1, 0),
             lib.RTPU_InitEx(folder.encode(), 2.0, 8, 0, PASSES, 1, 0),
             lib.RTPU_Deinit(),
             lib.RTPU_Process(*second.planes(), 2)]
    print(f"phase 22 error codes: SetDevice({n_cards}) then InitEx {codes[1]} (want "
          f"RTPU_ERROR_BAD_PARAMETER 1), InitEx on a missing folder {codes[3]}, "
          f"RTPU_Process after RTPU_Deinit {codes[6]}")
    if codes[0] or codes[1] != 1 or codes[2] or not codes[3] or codes[4] or codes[5] or \
            not codes[6]:
        fail(f"error codes {codes}")

    step_share = ms_step / N_FRAMES
    for dtype, (init_ms, ms_capi, ms_eng) in times.items():
        print(f"phase 22 times on {card}, 1080p -> 4K 8-bit {PASSES}-pass {dtype}: RTPU_InitEx "
              f"{init_ms:.1f} ms; RTPU_Process {ms_capi:.3f} ms a frame, engine.process "
              f"{ms_eng:.3f} ms, phase 4's process_batch_device {step_share:.3f} ms a frame "
              f"(float32, batch {N_FRAMES}) (host clock)")
    return launches, errs


def sweep_row_kernel(key: tuple, bits: int, mode: int, passes: int) -> str:
    """The `kernels` row a fused form of phase 23 counts in: the row of the
    phase that holds that form against its plain version."""
    tier, phases = key
    if phases == 1:
        return "full_kernel_single" if tier == "float32" else "full_kernel_single_bf16"
    if tier == "float32" and bits == 8:
        return "full_kernel_f32_8bit_mode2" if (mode, passes) == (2, 2) else "full_kernel"
    return {"float32": "full_kernel_f32_10bit", "pcenter": "full_kernel_pcenter_10bit",
            "int8": "full_kernel_int8_8bit", "bfloat16": "full_kernel_bf16"}[tier]


def sweep_cli(vs, argv: list, label: str) -> str:
    """One `raisr-torch upscale` of the sweep, in process: fails the phase
    unless it exits 0 without the marker; returns its last line."""
    rc, out, err = vs.run_cli(argv)
    if rc != 0 or vs.MARKER in out + err:
        raise SystemExit(f"phase 23 failed: {label}: exit {rc}: {(out + err)[-1000:]}")
    return (out + err).strip().splitlines()[-1]


def read_y4m(path: str):
    from raisr_tpu_torch import video

    rd = video.Y4MReader(path)
    frames = list(rd)
    rd.close()
    return rd.fmt, frames


def sweep_shards(card: str, tmp: str, root: str, vs) -> None:
    """Phase 23's --shard rows: each runs where data x rows cards are
    visible, on the 1080p clip, and must write the bytes of the same row
    without --shard; with fewer cards it prints SKIP."""
    import torch

    n_cards = torch.cuda.device_count()
    for row in vs.positive_rows():
        need, name = vs.shard_devices(row), vs.row_name(row)
        if need == 1:
            continue
        if need > n_cards:
            print(f"phase 23 SKIP (needs {need} cards, {n_cards} visible): {name}")
            continue
        src = vs.clip_for(tmp, row[2], LR_W, LR_H)
        extra = row[-1]
        k = extra.index("--shard")
        base = row[:-1] + (extra[:k] + extra[k + 2:],)
        outs, lines = [], []
        for r, tag in ((row, "sharded"), (base, "unsharded")):
            dst = os.path.join(tmp, f"sweep_{tag}.y4m")
            lines.append(sweep_cli(vs, vs.upscale_argv(r, root, src, dst), name))
            with open(dst, "rb") as f:
                outs.append(f.read())
        same = outs[0] == outs[1]
        print(f"phase 23 {name} over {need} of {n_cards} cards on {card}: {lines[0]}; the bytes of "
              f"the row without --shard: {same}")
        if not same:
            raise SystemExit(f"phase 23 failed: {name} differs from the row without --shard")


def run_sweep(dev, card: str, tmp: str) -> dict:
    """Phase 23: the validation sweep (raisr_tpu_torch.tools.validation_sweep)
    on the card, on the tool's seeded folders. Each positive row through
    `raisr-torch upscale` with no --device (the card is the default) on a
    clip of 2 seeded 1080p frames (8-bit, or 10-bit in [64, 940)): exit 0
    without the marker, 3840x2160 (2880x1620 at 1.5x) with U and V at the
    ratio, every frame equal, bit for bit, to RaisrEngine(cfg).process on
    the card (cfg built from the row's flags); only the fused form that
    pass_statics names launched, and as often as the dispatch groups and
    passes make. The same rows at 480x270 with --backend pallas on the card
    and with --device cpu (the kernel's plain version), byte for byte. The
    negative rows and corrupt folders by the tool's pass rule; the --shard
    rows by sweep_shards. Prints the phase's wall time (host clock). Returns
    the launches of the 1080p rows by `kernels` row."""
    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrEngine
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.tools import validation_sweep as vs

    t_start = time.perf_counter()
    root = vs.write_filter_folders(os.path.join(tmp, "filters"))
    launches: dict[str, int] = {}

    def fail(what: str):
        raise SystemExit(f"phase 23 failed: {what}")

    rows = [r for r in vs.positive_rows() if vs.shard_devices(r) == 1]
    for row in rows:
        name, (_, ratio, bits, passes, mode, _, extra) = vs.row_name(row), row
        src, dst = vs.clip_for(tmp, bits, LR_W, LR_H), os.path.join(tmp, "sweep_out.y4m")
        torch.cuda.synchronize()
        zero(fk.LAUNCHES)
        fk.EPILOGUE_LAUNCHES = 0
        glue_zero()
        t0 = time.perf_counter()
        line = sweep_cli(vs, vs.upscale_argv(row, root, src, dst), name)
        secs = time.perf_counter() - t0
        glue_read("23")
        counts = {k: n for k, n in fk.LAUNCHES.items() if n}
        b = fk.EPILOGUE_LAUNCHES
        cfg = vs.row_config(row, root)
        engine = RaisrEngine(cfg, device=dev)
        s = engine._statics
        key = (s.tier, s.pixel_types if s.use_pixel_type else 1)
        batch = int(extra[extra.index("--batch") + 1]) if "--batch" in extra else 1
        # one launch a pass over each group's stack; a resize without a
        # stacked form runs each frame of the (padded) group alone
        per_group = 1 if cfg.resize_mode == "bilinear" else batch
        expect = -(-2 // batch) * per_group * passes
        fmt, got = read_y4m(dst)
        out_h, out_w = cfg.output_size(LR_H, LR_W)
        uv = cfg.output_size(LR_H // 2, LR_W // 2)
        err = max(frame_err((g.y, g.u, g.v), engine.process(fr))
                  for fr, g in zip(read_y4m(src)[1], got))
        print(f"phase 23 {name} on {card}: {line} ({secs:.2f} s); output {fmt.width}x{fmt.height}"
              f" {fmt.bits}-bit, U/V {got[0].u.shape}, {len(got)} frames; against "
              f"RaisrEngine.process max abs {err}; fused form {counts} (pass_statics names "
              f"{key}, {expect} launches expected), launch B {b}")
        if ((fmt.width, fmt.height, fmt.bits, len(got)) != (out_w, out_h, bits, 2)
                or got[0].u.shape != uv or got[0].v.shape != uv):
            fail(f"{name}: output size")
        if err > KERNEL_MAX_ABS_ERR:
            fail(f"{name}: the CLI's frames differ from RaisrEngine.process")
        if counts != {key: expect} or b != expect:
            fail(f"{name}: launches {counts}, launch B {b}; expected {expect} of {key}")
        k = sweep_row_kernel(key, bits, mode, passes)
        launches[k] = launches.get(k, 0) + expect
        launches["full_kernel_epilogue"] = launches.get("full_kernel_epilogue", 0) + b

    t_small = time.perf_counter()
    # the card against the CPU's plain passes, byte for byte
    for row in rows:
        name = vs.row_name(row)
        src = vs.clip_for(tmp, row[2], 480, 270)
        outs = []
        for device in (None, "cpu"):
            dst = os.path.join(tmp, f"sweep_small_{device}.y4m")
            sweep_cli(vs, vs.upscale_argv(row, root, src, dst, "pallas", device),
                      f"{name} at 480x270 on {device or 'the card'}")
            outs.append(read_y4m(dst)[1])
        err = max(frame_err((a.y, a.u, a.v), b) for a, b in zip(*outs))
        frac = max(float(np.mean(a.y != b.y)) for a, b in zip(*outs))
        print(f"phase 23 {name} at 480x270, the card against --device cpu: max abs {err}, "
              f"Y differing {frac:.6%}")
        if err > KERNEL_MAX_ABS_ERR:
            fail(f"{name} at 480x270: the card's file differs from the CPU's")

    t_neg = time.perf_counter()
    clip = vs.clip_for(tmp, 8, LR_W, LR_H)
    for argv, desc in vs.negative_cases(root, tmp, clip):
        rc, out, err = vs.run_cli(argv)
        print(f"phase 23 negative {desc}: exit {rc}")
        if rc == 0:
            fail(f"negative {desc} succeeded")
    for name in vs.CORRUPT:
        rc, out, err = vs.run_cli(["upscale", "-i", clip, "-o", os.path.join(tmp, "neg.y4m"),
                                   "--filterfolder", vs.corrupt_folder(root, tmp, name)])
        print(f"phase 23 corrupt folder {name}: exit {rc}, marker {vs.MARKER in out + err}")
        if rc == 0 or vs.MARKER not in out + err:
            fail(f"corrupt folder {name}")
    sweep_shards(card, tmp, root, vs)
    t_end = time.perf_counter()
    print(f"phase 23 wall time on {card}: {t_end - t_start:.1f} s (host clock): folders and "
          f"1080p rows {t_small - t_start:.1f} s, 480x270 rows on the card and the CPU "
          f"{t_neg - t_small:.1f} s, negative rows and corrupt folders {t_end - t_neg:.1f} s")
    return launches


def sync_all(devs) -> None:
    import torch

    for d in dict.fromkeys(devs):
        torch.cuda.synchronize(d)


def run_cards(card: str, devs) -> None:
    """--cards N: the multi-device paths over N real cards (devs), beside
    the same mesh shapes over the first card alone. RaisrEngine(shard=...)
    for data=N, rows=N and data=N/2,rows=2 on phase 2's 4 frames against the
    unsharded engine, bit for bit, with the launch counts; the device time
    (CUDA events on the engine's card, which the gathered output waits for)
    and the host's enqueue time of each, and of the one-card mesh; one 4K
    float32 plane copied between two cards; train_step_sharded over data=N
    on 8 pairs against the one-card mesh, bit for bit."""
    import numpy as np
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.parallel import sharding as sh
    from raisr_tpu_torch.train import trainer as tr

    n, dev = len(devs), devs[0]
    with tempfile.TemporaryDirectory() as folder:
        model = make_bank(folder)
    cfg = RaisrConfig(passes=PASSES)
    yf = make_planes(N_FRAMES, LR_H, LR_W, 1, dev).to(torch.float32)
    base = RaisrEngine(cfg, model, device=dev)
    want = base.process_batch_y(yf)
    parts = [f"unsharded {enqueue_ms(lambda: base.process_batch_y(yf), 5)[0]:.3f} ms"]
    for spec, shape in ((f"data={n}", (n, 1)), (f"rows={n}", (1, n)),
                        (f"data={n // 2},rows=2", (n // 2, 2))):
        eng = RaisrEngine(cfg, model, shard=spec, device=dev)
        sync_all(devs)
        zero(fk.LAUNCHES)
        got = eng.process_batch_y(yf)
        sync_all(devs)
        per_frame = 1 if shape[1] == 1 else shape[1] * N_FRAMES // shape[0]
        expect = shape[0] * per_frame * PASSES
        same = torch.equal(got, want) and got.device == dev
        print(f"phase 21 cards {spec} over {eng._mesh}: equal to the unsharded engine bit for "
              f"bit: {same}; fused passes {fk.LAUNCHES[('float32', 4)]} (expected {expect})")
        if not same or fk.LAUNCHES[("float32", 4)] != expect:
            raise SystemExit(f"phase 21 failed: {spec} over {n} cards")
        one = sh.Mesh(np.array([dev] * n, dtype=object).reshape(shape), ("data", "rows"))

        def on_one():
            if shape[1] == 1:
                return sh.process_batch_dp(yf, eng._banks, eng._statics, PASSES, 1,
                                           2 * LR_H, 2 * LR_W, one)
            return sh.process_batch_2d(yf, eng._banks, eng._statics, PASSES, 1,
                                       2 * LR_H, 2 * LR_W, one)

        if not torch.equal(on_one(), want):
            raise SystemExit(f"phase 21 failed: {spec} over one card")
        cards_ms, cards_host = enqueue_ms(lambda: eng.process_batch_y(yf), 5)
        one_ms, one_host = enqueue_ms(on_one, 5)
        parts.append(f"{spec} {cards_ms:.3f} ms over {n} cards (host enqueue {cards_host:.3f}), "
                     f"{one_ms:.3f} over one ({one_host:.3f})")
    plane = torch.empty((2 * LR_H, 2 * LR_W), device=devs[1])
    copy_ms = cuda_ms(lambda: plane.to(dev), 20, 2)
    print(f"phase 21 cards times on {card}, {N_FRAMES} frames 1080p -> 4K, 2 passes, Y only: "
          f"{'; '.join(parts)}; a 4K float32 plane {devs[1]} -> {dev} {copy_ms:.4f} ms "
          f"({plane.numel() * 4 / copy_ms / 1e6:.1f} GB/s)")

    hrs = make_training_frames(TRAIN_FRAMES, LR_H, LR_W, 20, dev)
    pairs = [tr.degrade(x, 2.0, 8) for x in hrs]
    lr_b = torch.tensor(np.stack([p[0] for p in pairs]).astype(np.float32), device=dev)
    hr_b = torch.tensor(np.stack([p[1] for p in pairs]).astype(np.float32), device=dev)
    tcfg = tr.TrainConfig()
    ne.LAUNCHES = 0
    cards_bank = tr.train_step_sharded(lr_b, hr_b, tcfg, sh.make_mesh(n, ("data",), devs))
    sync_all(devs)
    launches = ne.LAUNCHES
    one_bank = tr.train_step_sharded(lr_b, hr_b, tcfg, sh.make_mesh(n, ("data",), [dev] * n))
    same = torch.equal(cards_bank, one_bank) and cards_bank.device == dev
    print(f"phase 21 cards train_step_sharded over data={n}, {len(pairs)} pairs: normal_eq "
          f"{launches}, equal to the one-card mesh's bank bit for bit: {same}")
    if not same or launches != len(pairs):
        raise SystemExit(f"phase 21 failed: train_step_sharded over {n} cards")


# the PyTorch chain the glue kernel replaces on the card's route: (module,
# name) of each piece, none of which phase 2's step may call
CHAIN = (("raisr_tpu_torch.ops.cuda.upscale", "guard_band_stack"),
         ("raisr_tpu_torch.ops.cuda.upscale", "unpack_planes"),
         ("raisr_tpu_torch.ops.pipeline", "unpack_planes"),
         ("raisr_tpu_torch.engine", "unpack_planes"),
         ("raisr_tpu_torch.ops.resize", "_upscale_axis_2x"))


@contextlib.contextmanager
def counting_calls(names):
    """Wraps each (module, function) of `names` in a stand-in that counts its
    calls, for the block; yields the counts by function name."""
    import importlib

    calls = {}
    saved = []
    for mod_name, fn_name in names:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        saved.append((mod, fn_name, fn))
        calls[f"{mod_name.rsplit('.', 1)[-1]}.{fn_name}"] = 0

        def stand_in(*a, _key=f"{mod_name.rsplit('.', 1)[-1]}.{fn_name}", _fn=fn, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        setattr(mod, fn_name, stand_in)
    try:
        yield calls
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def glue_kernels_a_step(step, steps: int = 5) -> tuple[float, float, float]:
    """Launches and device ms a call of `step` outside the fused pass's
    kernels (launches A1, A2, B), and the glue kernel's launches among them,
    from a torch.profiler trace of `steps` calls. One call runs inside the
    trace before them and is not counted: the trace can miss a kernel just
    after it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
        for _ in range(steps):
            with record_function("glue_step"):
                step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "glue.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    t0 = min(float(e["ts"]) for e in events if e.get("name") == "glue_step" and "dur" in e)
    glue = [e for e in events if e.get("cat") == "kernel" and "dur" in e
            and float(e["ts"]) >= t0 and not _kernel_group(e["name"]).startswith("launch")]
    ours = [e for e in glue if _kernel_group(e["name"]).startswith("glue")]
    return (len(glue) / steps, sum(float(e["dur"]) for e in glue) / steps / 1000,
            len(ours) / steps)


def run_glue(y, u, v, dev, card: str, engine, oy, filters, kw: dict, edges) -> dict:
    """Phase 24: the glue kernel (csrc/upscale.cu) against its plain version
    (ops/cuda/upscale.py), bit for bit, on the inputs the main paths hand it:
    phase 2's uint8 frames (Y guard 6, 2x; U and V packed in and out), phase
    7's 1.5x (the vectors' form), phase 14's uint16 frames at 10 and 16 bits
    (2x) and at 10 bits (1.5x), phase 19's mode-2 LR stack (guard 12) and
    its inter-pass upscale of pass 1's float32 stack; each timed beside its
    plain version, its bytes' bound and torch.nn.functional.interpolate
    (bilinear, align_corners=False) of the same planes as float32, which
    leaves out the rounding and the guard band. Then the glue of one 2x step
    from the profiler: the plain chain's launches and device ms (what the
    step ran before this kernel) beside the step's own. Returns the
    `cheap_upscale` row: the 2x Y form's numbers, the launches of every path
    driven (GLUE_LAUNCHES)."""
    import torch
    import torch.nn.functional as F

    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up

    def view(t):
        return t.view(torch.int16) if t.dtype == torch.uint16 else t

    def check(label, form, fn, ref, src, size):
        got, want = fn(), ref()
        torch.cuda.synchronize()
        same = (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(view(got), view(want)))
        err = 0.0 if same else float("inf")
        if not same and got.shape == want.shape:
            err = float((as_f64(got) - as_f64(want)).abs().max())
        planes = up.unpack_planes(src if src.dim() == 3 else src[None])[:, None]
        ms, plain = graph_ms(fn, 20), graph_ms(ref, 20)
        lib = graph_ms(lambda: F.interpolate(planes, size=size, mode="bilinear",
                                             align_corners=False), 20)
        bnd = bound(nbytes(src), nbytes(got), got.numel() * GLUE_OPS[form], "float32")
        print(f"phase 24 {label}: {tuple(src.shape)} {src.dtype} -> {tuple(got.shape)} "
              f"{got.dtype}, form {form}, vs plain max abs {err}; on {card}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
              f"{100 * bnd['bound_ms'] / ms:.1f}% of it), interpolate {lib:.4f} ms")
        if not (same and torch.isfinite(as_f64(got)).all()):
            raise SystemExit(f"phase 24 failed: {label}")
        return dict(err=err, ms=ms, plain=plain, lib=lib, bnd=bnd)

    out_h, out_w = 2 * LR_H, 2 * LR_W
    h15, w15 = 3 * LR_H // 2, 3 * LR_W // 2
    ch, cw = LR_H // 2, LR_W // 2
    results = []

    def stack(label, x, pad, oh, ow, bits, form):
        args = (x, N_FRAMES, LR_H, pad, oh, ow, bits)
        frames = x if x.dim() == 3 else x.reshape(N_FRAMES, -1, x.shape[-1])
        results.append(check(label, form, lambda: up.cheap_upscale_stack(*args),
                             lambda: up.cheap_upscale_stack_reference(*args), frames, (oh, ow)))

    def planes(label, p, oh, ow, bits):
        form = "2x" if (oh, ow) == (2 * p.shape[1], 2 * p.shape[2]) else "vec"
        args = (p, oh, ow, bits, p.dtype)
        results.append(check(label, form, lambda: up.cheap_upscale_planes(*args),
                             lambda: up.cheap_upscale_planes_reference(*args), p, (oh, ow)))

    stack("phase 2 Y, 2x, guard 6", y, 6, out_h, out_w, 8, "2x")
    main = results[0]
    planes("phase 2 U", u, LR_H, LR_W, 8)
    planes("phase 2 V", v, LR_H, LR_W, 8)
    stack("phase 7 Y, 1.5x, guard 6", y, 6, h15, w15, 8, "vec")
    planes("phase 7 U", u, 3 * ch // 2, 3 * cw // 2, 8)
    for bits in (10, 16):
        y16 = make_planes(N_FRAMES, LR_H, LR_W, 41, dev, bits)
        u16 = make_planes(N_FRAMES, ch, cw, 42, dev, bits)
        stack(f"phase 14 Y, {bits}-bit, 2x", y16, 6, out_h, out_w, bits, "2x")
        planes(f"phase 14 U, {bits}-bit, 2x", u16, LR_H, LR_W, bits)
        if bits == 10:
            stack("phase 14 Y, 10-bit, 1.5x", y16, 6, h15, w15, bits, "vec")
            planes("phase 14 U, 10-bit, 1.5x", u16, 3 * ch // 2, 3 * cw // 2, bits)
    stack("phase 19 Y, the LR stack, guard 12", y, 12, LR_H, LR_W, 8, "1x")
    lr = up.cheap_upscale_stack_reference(y, N_FRAMES, LR_H, 12, LR_H, LR_W, 8)
    pass1 = fk.raisr_pass_full(lr, filters[0], blending=2, frame_h=LR_H, frame_pad=12,
                               **dict(kw, **edges[0]))
    stack("phase 19 pass 1's float32 stack, 2x", pass1, 12, out_h, out_w, 8, "2x")

    # the glue of one 2x step: the plain chain (the step's glue before this
    # kernel: unpack, guard band, upscale and pack of Y; unpack, upscale and
    # pack of U and V) beside the step's kernels outside the fused pass
    oyf = up.unpack_planes(oy)
    n_before, ms_before, _ = glue_kernels_a_step(lambda: (
        up.cheap_upscale_stack_reference(y, N_FRAMES, LR_H, 6, out_h, out_w, 8),
        up.pack_planes(oyf, torch.uint8),
        up.cheap_upscale_planes_reference(u, LR_H, LR_W, 8, torch.uint8),
        up.cheap_upscale_planes_reference(v, LR_H, LR_W, 8, torch.uint8)))
    n_after, ms_after, n_kernel = glue_kernels_a_step(
        lambda: engine.process_batch_device(y, u, v))
    launches = sum(GLUE_LAUNCHES.values())
    print(f"phase 24 the glue of a 2x step ({N_FRAMES} frames 1080p -> 4K, 8-bit) on {card}, "
          f"from the profiler: the plain chain {n_before:g} launches, {ms_before:.3f} ms; the "
          f"step now {n_after:g} launches ({n_kernel:g} of the kernel), {ms_after:.3f} ms")
    print(f"phase 24 cheap_upscale launches by phase {GLUE_LAUNCHES}: {launches}")
    if n_kernel != 3 or not launches:
        raise SystemExit("phase 24 failed: the step's glue launches")
    row = kernel_row("cheap_upscale", "raisr_tpu_torch/csrc/upscale.cu",
                     "raisr_tpu/ops/resize.py:180 (XLA fusion, no Pallas)", launches,
                     [r["err"] for r in results], main["ms"], main["plain"], main["bnd"],
                     main["lib"])
    row["library_call"] = ("torch.nn.functional.interpolate(bilinear, align_corners=False) of "
                           "the frames as float32: no rounding, no guard band")
    return row


def graph_step(engine, y, u, v):
    """Warm up on a side stream, capture one serving step in a CUDA graph and
    replay it. Returns the graph's outputs (Y, U, V) and the graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        engine.process_batch_device(y, u, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = engine.process_batch_device(y, u, v)
    graph.replay()
    torch.cuda.synchronize()
    return out, graph


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace 10 steps of each path and write "
                             "DIR/step_trace.json (2x) and DIR/step15_trace.json (1.5x)")
    parser.add_argument("--cards", type=int, default=0, metavar="N",
                        help="instead of phases 1-24: the multi-device paths over N "
                             "visible cards (an even N >= 2) beside one card")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    import raisr_tpu_torch
    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import _build
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
    from raisr_tpu_torch.ops.cuda import upscale as up
    from raisr_tpu_torch.ops.resize import cheap_upscale

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"raisr_tpu_torch {raisr_tpu_torch.__version__}")

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    if args.cards:
        if args.cards < 2 or args.cards % 2 or torch.cuda.device_count() < args.cards:
            raise SystemExit(f"--cards {args.cards}: needs an even count >= 2 of visible cards "
                             f"({torch.cuda.device_count()} visible)")
        run_cards(card, [torch.device("cuda", i) for i in range(args.cards)])
        from raisr_tpu_torch.tools import validation_sweep as vs

        with tempfile.TemporaryDirectory() as tmp:
            sweep_shards(card, tmp, vs.write_filter_folders(os.path.join(tmp, "filters")), vs)
        return finish(card, [])

    with tempfile.TemporaryDirectory() as folder:
        model = make_bank(folder)
    cfg = RaisrConfig(passes=PASSES)
    out_h, out_w = cfg.output_size(LR_H, LR_W)

    y = make_planes(N_FRAMES, LR_H, LR_W, 1, dev)
    u = make_planes(N_FRAMES, LR_H // 2, LR_W // 2, 2, dev)
    v = make_planes(N_FRAMES, LR_H // 2, LR_W // 2, 3, dev)

    # -- phase 1: the kernel against its plain version -------------------------
    filters = [torch.tensor(b.filters, device=dev) for b in model.banks]
    kw = dict(
        k1d=tuple(float(x) for x in gaussian_kernel_1d(11)),
        nf=normalization_factor(8),
        min_val=cfg.min_val, max_val=cfg.max_val,
    )
    edges = [dict(qstr=tuple(float(q) for q in b.qstr),
                  qcoh=tuple(float(q) for q in b.qcoh)) for b in model.banks]
    kw0 = dict(kw, **edges[0])
    errs = []

    # one 4K plane, both blendings
    cheap = cheap_upscale(y[0].to(torch.float32), out_h, out_w, 8)
    for blending in (1, 2):
        errs.append(hold(
            "1 kernel", f"blending {blending}, one {out_h}x{out_w} plane",
            fk.raisr_pass_full(cheap, filters[0], blending=blending, **kw0),
            fk.raisr_pass_full_reference(cheap, filters[0], blending=blending, **kw0)))
    # the launches of the main path: each pass over the guard-banded stack of
    # all frames (LR guard 6 rows, 12 after the 2x upscale), every row held
    lr_pad = 6
    stack_lr = up.guard_band_stack(y.to(torch.float32), lr_pad)
    x = cheap_upscale(stack_lr, 2 * stack_lr.shape[0], out_w, 8)
    for p in range(PASSES):
        pkw = dict(kw, **edges[p], blending=2, frame_h=out_h, frame_pad=2 * lr_pad)
        got = fk.raisr_pass_full(x, filters[p], **pkw)
        errs.append(hold(
            "1 kernel", f"pass {p + 1} over the {N_FRAMES}-frame stack "
            f"{tuple(x.shape)} (frame_h {out_h}, frame_pad {2 * lr_pad})",
            got, fk.raisr_pass_full_reference(x, filters[p], **pkw)))
        x = got
    stack_y = x.reshape(N_FRAMES, out_h + 4 * lr_pad, out_w)[:, 2 * lr_pad: 2 * lr_pad + out_h]

    # -- phase 2: the main path ----------------------------------------------
    engine = RaisrEngine(cfg, model, device=dev)
    torch.cuda.synchronize()
    zero(fk.LAUNCHES)
    fk.EPILOGUE_LAUNCHES = fk.PACKED_EPILOGUE_LAUNCHES = 0
    glue_zero()
    with counting_calls(CHAIN) as chain_calls:
        oy, ou, ov = engine.process_batch_device(y, u, v)
        torch.cuda.synchronize()
    launches = fk.LAUNCHES[("float32", 4)]
    b_launches = fk.EPILOGUE_LAUNCHES
    packed_launches = fk.PACKED_EPILOGUE_LAUNCHES
    glue = dict(up.UPSCALE_LAUNCHES)
    glue_read("2")
    print(f"phase 2 glue launches {glue}; calls of the PyTorch chain it replaces {chain_calls}")
    if glue != {"1x": 0, "2x": 3, "vec": 0} or any(chain_calls.values()):
        raise SystemExit("phase 2 failed: the glue ran other than as 3 launches of the kernel")
    if sum(fk.LAUNCHES.values()) != launches:
        raise SystemExit(f"phase 2 failed: the 2x path launched another form {fk.LAUNCHES}")
    ok_shapes = (
        tuple(oy.shape) == (N_FRAMES, out_h, out_w)
        and tuple(ou.shape) == tuple(ov.shape) == (N_FRAMES, LR_H, LR_W)
        and oy.dtype == ou.dtype == ov.dtype == torch.uint8
        and oy.device.type == ou.device.type == ov.device.type == "cuda"
    )
    print(f"phase 2 main path: Y {tuple(oy.shape)} U/V {tuple(ou.shape)} "
          f"{oy.dtype} on {oy.device}, kernel passes launched {launches}, launch B "
          f"{b_launches} ({packed_launches} writing the packed Y frames)")
    if (not ok_shapes or launches != PASSES or b_launches != PASSES
            or packed_launches != 1):
        raise SystemExit("phase 2 failed: shapes, dtype, device or launch count")
    if not torch.equal(oy, stack_y.to(torch.uint8)):
        raise SystemExit("phase 2 failed: Y differs from phase 1's stacked launches")

    ref_engine = RaisrEngine(RaisrConfig(passes=PASSES, backend="reference"),
                             model, device=dev)
    for i in range(N_FRAMES):
        # against the plain fused passes, frame by frame (bit for bit)
        x = y[i].to(torch.float32)
        for p in range(PASSES):
            cur = cheap_upscale(x, out_h, out_w, 8) if p == 0 else x
            x = fk.raisr_pass_full_reference(cur, filters[p], blending=2,
                                             **dict(kw, **edges[p]))
        frac, med, mx = diff_stats(oy[i], x)
        print(f"phase 2 Y frame {i} vs plain passes: differing {frac:.6%}, "
              f"median {med}, max {mx}")
        if mx > KERNEL_MAX_ABS_ERR:
            raise SystemExit(f"phase 2 failed: Y frame {i} against the plain passes")
        # against the taps engine (the fuzz bar)
        frac, med, mx = diff_stats(oy[i], ref_engine.upscale_y(y[i].to(torch.float32)))
        print(f"phase 2 Y frame {i} vs taps engine: differing {frac:.6%}, "
              f"median {med}, max {mx}")
        if not (frac < FUZZ_MAX_FRAC and med == 0.0):
            raise SystemExit(f"phase 2 failed: Y frame {i} against the taps engine")
    for name, got, src in (("U", ou, u), ("V", ov, v)):
        for i in range(N_FRAMES):
            want = up.cheap_upscale_planes_reference(src[i], LR_H, LR_W, 8, torch.uint8)
            if not torch.equal(got[i], want):
                raise SystemExit(f"phase 2 failed: {name} frame {i} differs")
    print("phase 2 U/V equal the plain chroma upscale: yes")

    # -- phase 3: CUDA graph capture of the serving step ---------------------
    (gy, gu, gv), graph = graph_step(engine, y, u, v)
    same = torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)
    print(f"phase 3 CUDA graph replay equals eager: {same}")
    if not same:
        raise SystemExit("phase 3 failed")

    # -- phase 4: times -------------------------------------------------------
    ms_kernel = cuda_ms(lambda: fk.raisr_pass_full(cheap, filters[0], blending=2, **kw0), 20, 3)
    ms_plain = cuda_ms(
        lambda: fk.raisr_pass_full_reference(cheap, filters[0], blending=2, **kw0), 3)
    ms_kernel2 = cuda_ms(lambda: fk.raisr_pass_full(cheap, filters[0], blending=2, **kw0), 20, 3)
    ms_step = cuda_ms(lambda: engine.process_batch_device(y, u, v), 10, 2)
    ms_graph = cuda_ms(graph.replay, 10, 2)
    print(f"phase 4 times on {card}: fused pass {out_h}x{out_w} kernel "
          f"{ms_kernel:.3f} / {ms_kernel2:.3f} ms (before / after plain), plain "
          f"{ms_plain:.3f} ms; serving step {N_FRAMES} frames eager "
          f"{ms_step:.3f} ms = {N_FRAMES * 1000 / ms_step:.2f} frames/s, "
          f"graph {ms_graph:.3f} ms = {N_FRAMES * 1000 / ms_graph:.2f} frames/s")

    if args.profile:
        profile_steps(lambda: engine.process_batch_device(y, u, v), args.profile, card)

    single, c15 = run_15x(y, u, v, dev, card, kw, args.profile)
    rows = [kernel_row("full_kernel", "raisr_tpu_torch/csrc/full_kernel.cu",
                       "raisr_tpu/ops/pallas/full_kernel.py:82", launches, errs,
                       ms_kernel, ms_plain, pass_bound(cheap, filters[0])), single]
    rows += run_filter(y, dev, card, model, kw, c15, b_launches)
    bf16_rows, bf16_y = run_bf16(y, u, v, dev, card, model, kw, dict(oy=oy, ms_step=ms_step),
                                 c15, args.profile)
    rows += bf16_rows
    run_25x(y, dev, card, kw)
    row, int8_y, _ = run_tier(13, "int8 2x 2-pass", RaisrConfig(passes=PASSES, dtype="int8"),
                              model, (y, u, v), dev, card, base=oy)
    rows.append(row)
    rows += run_hibit(dev, card)
    rows.append(run_probe(dev, card))
    with tempfile.TemporaryDirectory() as tmp:
        row, c16 = run_stream(dev, card, tmp, kw, ms_step)
        rows.append(row)
        run_cli(card, tmp, c16)
    run_modes(y, u, v, dev, card, model, kw)
    row, mode2_y, _ = run_tier(19, "8-bit 2x 2-pass mode 2", RaisrConfig(passes=PASSES, mode=2),
                               model, (y, u, v), dev, card)
    rows.append(row)
    with tempfile.TemporaryDirectory() as tmp:
        row, held, hrs = run_train(dev, card, tmp, kw)
    rows.append(row)
    shard_launches, shard_errs = run_shard(
        dev, card, engine, y, {"2": oy, "7": c15["oy"], "11": bf16_y["2x"], "13": int8_y,
                               "19": mode2_y}, kw, edges, filters, c15, hrs)
    with tempfile.TemporaryDirectory() as tmp:
        capi_launches, capi_errs = run_capi(dev, card, tmp, ms_step)
    with tempfile.TemporaryDirectory() as tmp:
        sweep_launches = run_sweep(dev, card, tmp)
    rows.append(run_glue(y, u, v, dev, card, engine, oy, filters, kw, edges))
    # the training, sharding and C ABI paths' holds of earlier rows' kernels
    # count in those rows, and the sharding, C ABI and sweep paths' launches
    # with the main path's
    missing = set(sweep_launches) - {r["name"] for r in rows}
    if missing:
        raise SystemExit(f"phase 23 failed: no `kernels` row for {sorted(missing)}")
    for r in rows:
        r["max_abs_err"] = max([r["max_abs_err"], *held.get(r["name"], []),
                                *shard_errs.get(r["name"], []),
                                *capi_errs.get(r["name"], [])])
        r["launches"] += (shard_launches.get(r["name"], 0) + capi_launches.get(r["name"], 0)
                          + sweep_launches.get(r["name"], 0))
    return finish(card, rows)


def finish(card: str, rows: list) -> int:
    """The last three lines: the `kernels` line, the card, the result."""
    import torch

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
