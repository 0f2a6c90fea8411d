#!/usr/bin/env python3
"""Smoke run of raisr_tpu_torch's serving paths on one NVIDIA card.

Usage, from the root of a checkout:

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile DIR    # and torch.profiler phases

It builds the port's CUDA kernels from the checkout's sources, then, for the
2x path (the 4-phase kernel):
  1. holds the fused-pass kernel against its plain PyTorch version, bit for
     bit: on one 4K plane for both census blendings, and on the very planes
     the main path hands it (both passes over the 4-frame guard-banded stack);
  2. drives the main path once, RaisrEngine.process_batch_device on 4 frames
     of 8-bit YUV420 1080p -> 4K, 2 passes, CountOfBitsChanged, with a bank
     of the real shape made from a seed, and checks every frame against the
     plain passes, the port's taps engine and the chroma upscale;
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
Each path is driven with the launch counts set to 0 just before it and read
just after. Its last line is {"ok": true, "device": {...}}. It imports nothing of jax or
raisr_tpu, and exits non-zero, with no result line, when there is no CUDA
card or any phase fails.
"""

from __future__ import annotations

import argparse
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def diff_stats(a, b) -> tuple[float, float, float]:
    """(share of differing pixels, median and max absolute difference)."""
    import torch

    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return (float((d > 0).double().mean()), float(d.median()), float(d.max()))


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
              ratio: float = 2.0, seed: int = 0):
    """Write and reload a bank of the real shape (216 buckets x pixel_types
    phases x 121 taps; 4 phases for 2x, 1 for 1.5x): centre tap 1 plus noise
    of 0.01, from `seed`."""
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
    save_filter_folder(folder, banks, bits=8)
    return load_model(folder, RaisrConfig(passes=passes, ratio=ratio))


def make_planes(n: int, h: int, w: int, seed: int, device):
    """Smooth seeded uint8 content in [16, 235]: coarse and fine noise,
    bilinearly enlarged on the card, so edges of every orientation occur."""
    import numpy as np
    import torch
    import torch.nn.functional as F

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
    return torch.round(16 + out[:, 0] * 219).to(torch.uint8)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median over `iters` of one call's device time, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


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
    for key, label in (("hash_filter_kernel", "launch A hash_filter_kernel"),
                       ("epilogue_kernel", "launch B epilogue_kernel"),
                       ("CatArrayBatchedCopy", "PyTorch cat"),
                       ("gather", "PyTorch gather (non-2x resize)"),
                       ("elementwise", "PyTorch elementwise")):
        if key in name:
            return label
    return "other"


def profile_steps(step, out_dir: str, card: str, steps: int = 10,
                  phase: int = 5, name: str = "step_trace.json") -> None:
    """Phase 5 (and 9): trace `steps` serving steps; print the device time
    per step by kernel group and the busy share: the union of the kernels'
    device intervals over the window from the first step's start on the host
    to the last kernel's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
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
    if not kernels or not marks:
        raise SystemExit(f"phase {phase} failed: the trace holds no device kernels")
    t0 = min(float(e["ts"]) for e in marks)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in kernels)
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        g = _kernel_group(e["name"])
        groups[g] = groups.get(g, 0.0) + float(e["dur"])
    total = sum(groups.values())
    print(f"phase {phase} profile on {card}: {steps} steps, {len(kernels) / steps:g} "
          f"kernels per step, trace {path}")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"phase {phase}   {g}: {us / steps / 1000:.3f} ms per step, "
              f"{100 * us / total:.1f}% of kernel time")
    print(f"phase {phase} device busy {busy / 1000:.3f} of {(t1 - t0) / 1000:.3f} ms "
          f"of the traced window = {100 * busy / (t1 - t0):.1f}%")


def run_15x(y, u, v, dev, card: str, kw: dict, profile_dir: str | None) -> dict:
    """Phases 6-9: the 1.5x path (single-phase kernel) on the frames of the
    2x phases. Returns the kernel's entry of the `kernels` line."""
    import torch

    from raisr_tpu_torch import RaisrConfig, RaisrEngine
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.ops.cuda import full_kernel as fk
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
            fk.raisr_pass_full_single(cheap, filters, blending=blending, **kw),
            fk.raisr_pass_full_single_reference(cheap, filters, blending=blending, **kw)))
    # the launch of the 1.5x path: the stack of all frames, LR guard 6 rows,
    # 9 after the upscale, every row held
    lr_pad, hr_pad = 6, 6 * out_h // LR_H
    stack_lr = pipeline.guard_band_stack(y.to(torch.float32), lr_pad)
    stack = cheap_upscale_stacked(stack_lr, N_FRAMES, LR_H, lr_pad, out_h, hr_pad, out_w, 8)
    skw = dict(kw, blending=2, frame_h=out_h, frame_pad=hr_pad)
    got = fk.raisr_pass_full_single(stack, filters, **skw)
    errs.append(hold(
        "6 single-phase kernel", f"the {N_FRAMES}-frame stack {tuple(stack.shape)} "
        f"(frame_h {out_h}, frame_pad {hr_pad})",
        got, fk.raisr_pass_full_single_reference(stack, filters, **skw)))
    stack_y = got.reshape(N_FRAMES, out_h + 2 * hr_pad, out_w)[:, hr_pad: hr_pad + out_h]

    # -- phase 7: the 1.5x path ------------------------------------------------
    engine = RaisrEngine(cfg, model, device=dev)
    torch.cuda.synchronize()
    fk.LAUNCHES = fk.SINGLE_LAUNCHES = 0
    oy, ou, ov = engine.process_batch_device(y, u, v)
    torch.cuda.synchronize()
    launches = fk.SINGLE_LAUNCHES
    ok_shapes = (
        tuple(oy.shape) == (N_FRAMES, out_h, out_w)
        and tuple(ou.shape) == tuple(ov.shape) == (N_FRAMES, ch, cw)
        and oy.dtype == ou.dtype == ov.dtype == torch.uint8
        and oy.device.type == ou.device.type == ov.device.type == "cuda"
    )
    print(f"phase 7 1.5x path: Y {tuple(oy.shape)} U/V {tuple(ou.shape)} {oy.dtype} "
          f"on {oy.device}, single-phase kernel passes launched {launches}, "
          f"4-phase {fk.LAUNCHES}")
    if not ok_shapes or launches != PASSES_15X or fk.LAUNCHES:
        raise SystemExit("phase 7 failed: shapes, dtype, device or launch count")
    if not torch.equal(oy, stack_y.to(torch.uint8)):
        raise SystemExit("phase 7 failed: Y differs from phase 6's stacked launch")
    ref_engine = RaisrEngine(RaisrConfig(ratio=1.5, passes=PASSES_15X, backend="reference"),
                             model, device=dev)
    for i in range(N_FRAMES):
        x = fk.raisr_pass_full_single_reference(
            cheap_upscale(y[i].to(torch.float32), out_h, out_w, 8), filters,
            blending=2, **kw)
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
            want = pipeline.process_plane_uv(src[i], ch, cw, 8).to(torch.uint8)
            if not torch.equal(got[i], want):
                raise SystemExit(f"phase 7 failed: {name} frame {i} differs")
    print("phase 7 U/V equal process_plane_uv: yes")

    # -- phase 8: CUDA graph capture of the 1.5x step --------------------------
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        engine.process_batch_device(y, u, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gu, gv = engine.process_batch_device(y, u, v)
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)
    print(f"phase 8 CUDA graph replay of the 1.5x step equals eager: {same}")
    if not same:
        raise SystemExit("phase 8 failed")

    # -- phase 9: times ----------------------------------------------------------
    dkw = dict(kw, blending=2)
    ms_kernel = cuda_ms(lambda: fk.raisr_pass_full_single(cheap, filters, **dkw), 20, 3)
    ms_plain = cuda_ms(lambda: fk.raisr_pass_full_single_reference(cheap, filters, **dkw), 3)
    ms_kernel2 = cuda_ms(lambda: fk.raisr_pass_full_single(cheap, filters, **dkw), 20, 3)
    ms_stack = cuda_ms(lambda: fk.raisr_pass_full_single(stack, filters, **skw), 10, 2)
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
    return {
        "name": "full_kernel_single",
        "route": "cuda",
        "source": "raisr_tpu_torch/csrc/full_kernel.cu",
        "replaces": "raisr_tpu/ops/pallas/full_kernel.py:952",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also trace 10 steps of each path and write "
                             "DIR/step_trace.json (2x) and DIR/step15_trace.json (1.5x)")
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
    stack_lr = pipeline.guard_band_stack(y.to(torch.float32), lr_pad)
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
    fk.LAUNCHES = fk.SINGLE_LAUNCHES = 0
    oy, ou, ov = engine.process_batch_device(y, u, v)
    torch.cuda.synchronize()
    launches = fk.LAUNCHES
    if fk.SINGLE_LAUNCHES:
        raise SystemExit("phase 2 failed: the 2x path launched the single-phase kernel")
    ok_shapes = (
        tuple(oy.shape) == (N_FRAMES, out_h, out_w)
        and tuple(ou.shape) == tuple(ov.shape) == (N_FRAMES, LR_H, LR_W)
        and oy.dtype == ou.dtype == ov.dtype == torch.uint8
        and oy.device.type == ou.device.type == ov.device.type == "cuda"
    )
    print(f"phase 2 main path: Y {tuple(oy.shape)} U/V {tuple(ou.shape)} "
          f"{oy.dtype} on {oy.device}, kernel passes launched {launches}")
    if not ok_shapes or launches != PASSES:
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
            want = pipeline.process_plane_uv(src[i], LR_H, LR_W, 8).to(torch.uint8)
            if not torch.equal(got[i], want):
                raise SystemExit(f"phase 2 failed: {name} frame {i} differs")
    print("phase 2 U/V equal process_plane_uv: yes")

    # -- phase 3: CUDA graph capture of the serving step ---------------------
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        engine.process_batch_device(y, u, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gu, gv = engine.process_batch_device(y, u, v)
    graph.replay()
    torch.cuda.synchronize()
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

    single = run_15x(y, u, v, dev, card, kw, args.profile)
    print(json.dumps({"kernels": [{
        "name": "full_kernel",
        "route": "cuda",
        "source": "raisr_tpu_torch/csrc/full_kernel.cu",
        "replaces": "raisr_tpu/ops/pallas/full_kernel.py:82",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }, single]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
