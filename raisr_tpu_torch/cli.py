"""Command-line interface.

Port of raisr_tpu/cli.py. Mirrors the `vf_raisr` FFmpeg filter's knob surface
(reference: ffmpeg/vf_raisr.c:81-94: ratio, bits, range, filterfolder,
blending, passes, mode, evenoutput) on a standalone upscaler:

    raisr-torch upscale -i in.y4m -o out.y4m --ratio 2 --passes 2 \
        --filterfolder filters_2x/filters_highres
    raisr-torch upscale -i in.png -o out.png            # single image
    raisr-torch info --filterfolder filters_2x/filters_lowres
    raisr-torch bench --width 1920 --height 1080 --frames 20

Every subcommand that runs the engine takes --device (default cuda: the
hand-written kernels on the card; a machine without one gets a RaisrError,
never a silent CPU run). `--device cpu` runs the plain PyTorch passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from raisr_tpu_torch.config import RaisrConfig, BlendingMode, RangeType, Backend, RaisrError
from raisr_tpu_torch.engine import RaisrEngine


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--filterfolder", default="filters_2x/filters_lowres")
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on: cuda (default; "
                        "cuda:N picks a card) or cpu")
    p.add_argument("--ratio", type=float, default=2.0)
    p.add_argument("--bits", type=int, default=8, choices=[8, 10, 16])
    p.add_argument("--range", dest="range_", default="video", choices=["video", "full"])
    p.add_argument("--blending", type=int, default=2, choices=[1, 2],
                   help="1: Randomness, 2: CountOfBitsChanged")
    p.add_argument("--passes", type=int, default=1, choices=[1, 2])
    p.add_argument("--mode", type=int, default=1, choices=[1, 2],
                   help="two-pass mode (1: upscale 1st pass, 2: upscale 2nd pass)")
    p.add_argument("--evenoutput", action="store_true")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "reference", "xla", "pallas"])
    p.add_argument("--dtype", default="float32",
                   choices=["auto", "float32", "bfloat16", "bfloat16_exact",
                            "int8"],
                   help="compute precision tier of the fused pass: float32 "
                        "matches the reference's AVX2/AVX512 quality; "
                        "bfloat16 is the AVX512-FP16 analogue (the bank "
                        "rounded to bf16 with error diffusion). At 10-bit "
                        "it runs the centered form (patches centered at "
                        "512 before the bf16 cast); at 16-bit the bf16 "
                        "bank against the exact patch (p_split). "
                        "bfloat16_exact forces p_split at 10-bit too. int8 "
                        "(8-bit content only) runs the bank as fixed-point "
                        "integers: quality between bfloat16 and float32. "
                        "auto mirrors the reference's production ISA "
                        "auto-pick (Raisr.cpp:1492-1501) (= bfloat16)")
    p.add_argument("--resize-mode", default="bilinear",
                   choices=["bilinear", "cubic", "lanczos"],
                   help="cheap-upscale resampler (the reference's "
                        "USE_BICUBIC/USE_LANCZOS compile options as a "
                        "runtime knob; cubic is B=0 C=0.75, lanczos is "
                        "3-lobe)")


def _cfg(args) -> RaisrConfig:
    return RaisrConfig(
        filterfolder=args.filterfolder,
        ratio=args.ratio,
        bits=args.bits,
        range=RangeType.VIDEO if args.range_ == "video" else RangeType.FULL,
        blending=BlendingMode(args.blending),
        passes=args.passes,
        mode=args.mode,
        evenoutput=args.evenoutput,
        backend=Backend(args.backend),
        dtype=args.dtype,
        resize_mode=args.resize_mode,
    )


def cmd_upscale(args) -> int:
    from raisr_tpu_torch import video

    if args.output == "-":
        # Y4M data rides stdout: keep logs (incl. the engine init banner)
        # off the pipe
        from raisr_tpu_torch.utils.logging import to_stderr

        to_stderr()
    cfg = _cfg(args)
    engine = RaisrEngine(cfg, shard=getattr(args, "shard", None),
                         device=args.device)

    in_ext = os.path.splitext(args.input)[1].lower()
    if in_ext in (".png", ".jpg", ".jpeg", ".bmp"):
        frame = video.read_png_as_yuv(args.input, cfg.bits)
        out = engine.process(frame)
        video.write_yuv_as_png(out, args.output, cfg.bits)
        print(f"wrote {args.output} ({out.y.shape[1]}x{out.y.shape[0]})")
        return 0

    fmt = None
    if in_ext in (".yuv", ".raw") or (args.input == "-" and args.size):
        if not args.size:
            raise RaisrError("raw YUV input requires --size WxH")
        w, h = (int(x) for x in args.size.lower().split("x"))
        fmt = video.VideoFormat(w, h, cfg.bits, args.format)
    reader = video.open_reader(args.input, fmt)
    in_fmt = reader.fmt
    out_h, out_w = cfg.output_size(in_fmt.height, in_fmt.width)
    writer = video.open_writer(args.output, in_fmt.scaled(out_h, out_w))

    from raisr_tpu_torch.stream import StreamProcessor
    import itertools

    stream = StreamProcessor(engine, depth=args.pipeline_depth, batch=args.batch)
    frames = iter(reader)
    if args.frames:
        frames = itertools.islice(frames, args.frames)

    count = 0
    start = time.perf_counter()
    for out in stream.process(frames):
        writer.write(out)
        count += 1
    elapsed = time.perf_counter() - start
    reader.close()
    writer.close()
    print(
        f"processed {count} frames {in_fmt.width}x{in_fmt.height} -> "
        f"{out_w}x{out_h} in {elapsed:.2f}s ({count / max(elapsed, 1e-9):.2f} fps)",
        # keep the pipe clean when the Y4M stream goes to stdout
        file=sys.stderr if args.output == "-" else sys.stdout,
    )
    return 0


def cmd_info(args) -> int:
    from raisr_tpu_torch.model.loader import load_model

    cfg = _cfg(args)
    model = load_model(cfg.filterfolder, cfg)
    info = {
        "filterfolder": cfg.filterfolder,
        "qangle": model.qangle,
        "qstrength": model.qstrength,
        "qcoherence": model.qcoherence,
        "patch_size": model.patch_size,
        "passes": len(model.banks),
        "banks": [
            {
                "hashkey_size": b.hashkey_size,
                "pixel_types": b.pixel_types,
                "taps": b.taps,
                "dtype": b.source_dtype,
                "qstr": b.qstr.tolist(),
                "qcoh": b.qcoh.tolist(),
            }
            for b in model.banks
        ],
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_compare(args) -> int:
    """PSNR/SSIM between two clips (golden-comparison workflow)."""
    from raisr_tpu_torch import video
    from raisr_tpu_torch.utils.metrics import ssim
    from raisr_tpu_torch.io_native import plane_mse
    import math

    ra = video.open_reader(args.a)
    rb = video.open_reader(args.b)
    max_val = float((1 << ra.fmt.bits) - 1)
    count = 0
    mse_sum = 0.0
    ssim_sum = 0.0
    for fa, fb in zip(ra, rb):
        if fa.y.shape != fb.y.shape:
            raise RaisrError(
                f"frame size mismatch: {fa.y.shape} vs {fb.y.shape}"
            )
        mse_sum += plane_mse(fa.y, fb.y)
        if args.ssim:
            ssim_sum += ssim(fa.y, fb.y, max_val)
        count += 1
        if args.frames and count >= args.frames:
            break
    ra.close()
    rb.close()
    if count == 0:
        raise RaisrError("no frames compared")
    mean_mse = mse_sum / count
    p = float("inf") if mean_mse == 0 else 10.0 * math.log10(max_val * max_val / mean_mse)
    result = {"frames": count, "psnr_y_db": round(p, 3)}
    if args.ssim:
        result["ssim_y"] = round(ssim_sum / count, 5)
    print(json.dumps(result))
    return 0


def _device_name(device) -> str:
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def cmd_bench(args) -> int:
    import torch

    from raisr_tpu_torch.utils.profiler import device_fence

    cfg = _cfg(args)
    engine = RaisrEngine(cfg, shard=getattr(args, "shard", None),
                         device=args.device)
    dev = engine.device
    rng = np.random.default_rng(0)
    lr_np = rng.integers(16, 235, size=(args.height, args.width)).astype(np.float32)

    if getattr(args, "latency", False):
        # single-stream latency mode: one frame in flight, fenced per frame
        # (worst case: H2D + both passes + D2H on the critical path), plus
        # the depth-2 pipelined single-stream rate (asynchronous launches
        # overlap frame k's read-back with frame k+1's staging and compute)
        def one(x):
            return engine.upscale_y(torch.as_tensor(x, device=dev)).cpu().numpy()

        one(lr_np)  # builds the kernels, warms the allocator
        lat = []
        for i in range(args.frames):
            x = lr_np + np.float32(i % 7)
            t0 = time.perf_counter()
            one(x)  # the copy to the host fences the frame
            lat.append(time.perf_counter() - t0)
        lat_ms = sorted(lat)[len(lat) // 2] * 1000
        # pipelined: keep 2 in flight, fence only the trailing frame
        from raisr_tpu_torch.stream import StreamProcessor
        from raisr_tpu_torch.engine import Frame as _Frame

        frames = [
            _Frame(y=lr_np + np.float32(i % 7)) for i in range(args.frames)
        ]
        sp = StreamProcessor(engine, depth=2)
        sum(1 for _ in sp.process(iter(frames[:4])))  # pinned buffers, warm
        t0 = time.perf_counter()
        n_out = sum(1 for _ in sp.process(iter(frames)))
        piped = (time.perf_counter() - t0) / n_out
        print(json.dumps({
            "metric": f"{args.width}x{args.height} single-stream latency",
            "fenced_ms_per_frame": round(lat_ms, 2),
            "pipelined_ms_per_frame": round(piped * 1000, 2),
            "pipelined_fps": round(1 / piped, 2),
            "device": _device_name(dev),
        }))
        return 0
    lr = torch.as_tensor(lr_np, device=dev)
    # distinct input per iteration; the launches are asynchronous, so the
    # clock stops only behind a fence on the device
    out = engine.upscale_y(lr)  # builds the kernels + fence
    device_fence(out)
    start = time.perf_counter()
    for i in range(args.frames):
        out = engine.upscale_y(lr + float(i % 7))
    device_fence(out)  # the device executes in order: this fences the chain
    elapsed = time.perf_counter() - start
    fps = args.frames / elapsed
    print(
        json.dumps(
            {
                "metric": f"{args.width}x{args.height}->{cfg.output_size(args.height, args.width)[::-1]} "
                f"passes={cfg.passes} Y fps",
                "value": round(fps, 3),
                "unit": "frames/sec",
                "device": _device_name(dev),
            }
        )
    )
    return 0


def cmd_train(args) -> int:
    """Training is not part of raisr_tpu_torch yet: refuse, naming the item."""
    raise RaisrError(
        "train is not ported to raisr_tpu_torch yet (ROADMAP "
        "A11); train a bank with raisr_tpu's `raisr train` and serve its "
        "folder here."
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raisr-torch", description=__doc__)
    from raisr_tpu_torch import __version__

    parser.add_argument("--version", action="version",
                        version=f"raisr_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p_up = sub.add_parser("upscale", help="upscale a video or image")
    p_up.add_argument("-i", "--input", required=True)
    p_up.add_argument("-o", "--output", required=True)
    p_up.add_argument("--frames", type=int, default=0, help="max frames (0=all)")
    p_up.add_argument("--pipeline-depth", type=int, default=2,
                      help="frames kept in flight on the device")
    p_up.add_argument("--batch", type=int, default=1,
                      help="frames per device dispatch (device-resident "
                           "batched mode; output identical to --batch 1)")
    p_up.add_argument("--size", default=None, help="WxH for raw .yuv input")
    p_up.add_argument("--shard", default=None,
                      help="multi-device spec: data=N[,rows=M]; any spec "
                           "over one device is refused until multi-device "
                           "serving is ported (ROADMAP A13)")
    p_up.add_argument(
        "--format", default="420", choices=["420", "422", "444", "nv12", "mono"]
    )
    _add_common(p_up)
    p_up.set_defaults(fn=cmd_upscale)

    p_info = sub.add_parser("info", help="inspect a filter folder")
    _add_common(p_info)
    p_info.set_defaults(fn=cmd_info)

    p_cmp = sub.add_parser("compare", help="PSNR/SSIM between two clips")
    p_cmp.add_argument("a")
    p_cmp.add_argument("b")
    p_cmp.add_argument("--frames", type=int, default=0)
    p_cmp.add_argument("--ssim", action="store_true")
    p_cmp.set_defaults(fn=cmd_compare)

    p_bench = sub.add_parser("bench", help="synthetic Y-plane throughput")
    p_bench.add_argument("--width", type=int, default=1920)
    p_bench.add_argument("--height", type=int, default=1080)
    p_bench.add_argument("--frames", type=int, default=20)
    p_bench.add_argument("--shard", default=None,
                         help="multi-device spec: data=N[,rows=M] (refused, "
                              "ROADMAP A13)")
    p_bench.add_argument("--latency", action="store_true",
                         help="single-stream latency mode: fenced per-frame "
                              "latency + depth-2 pipelined rate")
    _add_common(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_tr = sub.add_parser(
        "train", help="train a filter bank (not ported yet: ROADMAP A11; "
                      "the flags are raisr_tpu's)"
    )
    p_tr.add_argument("-o", "--output", required=True,
                      help="filter folder to write (reference format)")
    p_tr.add_argument("-i", "--inputs", nargs="+", required=True,
                      help="HR sources: .y4m/.png/... (LR = 2x box downscale)")
    p_tr.add_argument("--ratio", type=float, default=2.0, choices=[2.0, 1.5],
                      help="upscale ratio to train for (1.5 trains a "
                           "single-phase bank; LR = exact 2/3 area "
                           "downscale)")
    p_tr.add_argument("--bits", type=int, default=8, choices=[8, 10, 16])
    p_tr.add_argument("--passes", type=int, default=1, choices=[1, 2],
                      help="2: also train a second-pass (sharpening) bank "
                           "on the pass-1 inference output (two-pass "
                           "mode-1 semantics)")
    p_tr.add_argument("--frames", type=int, default=0,
                      help="max frames per video source (0=all)")
    p_tr.add_argument("--augment", action="store_true",
                      help="8-way dihedral symmetry augmentation")
    p_tr.add_argument("--lam", type=float, default=0.01,
                      help="Tikhonov regularization")
    p_tr.add_argument("--chunk", type=int, default=2048)
    p_tr.add_argument("--eval-holdout", type=int, default=8, metavar="N",
                      help="hold out every Nth frame from training and "
                           "report hold-out PSNR of the trained bank "
                           "(0 disables)")
    p_tr.add_argument("--resize-mode", default="bilinear",
                      choices=["bilinear", "cubic", "lanczos"],
                      help="cheap upscaler the bank is trained against "
                           "(must match the inference --resize-mode)")
    p_tr.add_argument("--ct-refine", action="store_true",
                      help="CT-blend-aware weighted least squares: after a "
                           "plain sweep, re-solve with each pixel weighted "
                           "by its census-blend filter share (optimizes the "
                           "blended output the user actually sees)")
    p_tr.add_argument("--blending", type=int, default=2, choices=[1, 2],
                      help="blend mode the --ct-refine weights model "
                           "(1=Randomness, 2=CountOfBitsChanged)")
    p_tr.add_argument("--eval-against", default=None, metavar="FOLDER",
                      help="also report hold-out PSNR of this existing "
                           "filter folder for comparison")
    p_tr.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except RaisrError as e:
        print(str(e), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
