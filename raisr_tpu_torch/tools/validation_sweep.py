"""End-to-end validation sweep over the port's CLI (`raisr-torch`).

Port of tools/validation_sweep.py, itself a re-creation of the reference's
validation suite (reference: test/validation_suite/run_tests_avxout.sh,
create_wrong_files.sh):
  - positive sweep: every filter folder at its proper ratio, passes {1,2},
    blending {1,2}, mode {1,2}, 8/10-bit, --batch, --dtype, --shard and
    --resize-mode;
  - negative sweep: bad bits / blending / mode / passes, a missing folder,
    int8 where it has no form, sharding with a non-bilinear resize, a
    missing input, a directory as input, and corrupt model folders.
Pass rule, the reference's log-grep: a positive run exits 0 and prints no
"[RAISR ERROR]"; a negative run exits nonzero; a corrupt folder exits
nonzero and prints the marker.

The filter folders are written under the workdir from a seed, at the
reference's shapes (`write_filter_folders`), unless --filters-root names a
directory that holds filters_2x/ and filters_1.5x/ folders.

Usage:
    python -m raisr_tpu_torch.tools.validation_sweep [--device cuda|cpu]
        [--workdir DIR] [--filters-root DIR] [--backend auto] [--quick]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from raisr_tpu_torch import video
from raisr_tpu_torch.cli import main as cli_main
from raisr_tpu_torch.config import BlendingMode, RaisrConfig
from raisr_tpu_torch.engine import Frame, parse_shard_spec
from raisr_tpu_torch.model.loader import FilterBank
from raisr_tpu_torch.train.export import save_filter_folder

MARKER = "[RAISR ERROR]"

# folder (under the filters root), ratio, bits, passes, mode, blending
POSITIVE = [
    ("filters_2x/filters_lowres", 2.0, 8, 1, 1, 2),
    ("filters_2x/filters_lowres", 2.0, 8, 2, 1, 1),
    ("filters_2x/filters_lowres", 2.0, 10, 1, 1, 2),
    ("filters_2x/filters_highres", 2.0, 8, 2, 1, 2),
    ("filters_2x/filters_highres", 2.0, 10, 2, 1, 1),
    ("filters_2x/filters_denoise", 2.0, 8, 2, 2, 2),
    ("filters_2x/filters_denoise", 2.0, 10, 2, 2, 2),
    ("filters_1.5x/filters_highres", 1.5, 8, 1, 1, 2),
    ("filters_1.5x/filters_denoise", 1.5, 8, 2, 2, 1),
]

# the same with extra flags: batching, the precision tiers, sharding and the
# resize modes
POSITIVE_EXTRA = [
    ("filters_2x/filters_highres", 2.0, 8, 2, 1, 2, ["--batch", "2"]),
    ("filters_2x/filters_highres", 2.0, 8, 1, 1, 2, ["--dtype", "bfloat16"]),
    ("filters_2x/filters_lowres", 2.0, 8, 2, 1, 2, ["--batch", "3", "--dtype", "bfloat16"]),
    ("filters_2x/filters_lowres", 2.0, 8, 1, 1, 2, ["--batch", "4", "--shard", "data=2"]),
    ("filters_2x/filters_lowres", 2.0, 8, 1, 1, 2,
     ["--batch", "2", "--shard", "data=2,rows=2"]),
    ("filters_2x/filters_highres", 2.0, 10, 2, 1, 2, ["--dtype", "bfloat16"]),
    ("filters_2x/filters_lowres", 2.0, 8, 1, 1, 2, ["--dtype", "int8"]),
    ("filters_1.5x/filters_highres", 1.5, 8, 1, 1, 2, ["--dtype", "bfloat16"]),
    ("filters_2x/filters_lowres", 2.0, 8, 1, 1, 2, ["--resize-mode", "cubic"]),
    ("filters_2x/filters_lowres", 2.0, 8, 2, 1, 2, ["--resize-mode", "lanczos", "--batch", "2"]),
]

# extra args (after the base `upscale` args, so a repeated flag wins) and a
# description; {root} is the filters root
NEGATIVE_ARGS = [
    (["--bits", "9"], "bits=9"),
    (["--blending", "0"], "blending=0"),
    (["--mode", "-1"], "mode=-1"),
    (["--passes", "3"], "passes=3"),
    (["--filterfolder", "/nonexistent/folder"], "missing filterfolder"),
    (["--dtype", "int8", "--bits", "10"], "int8 at 10-bit"),
    (["--dtype", "int8", "--ratio", "1.5",
      "--filterfolder", "{root}/filters_1.5x/filters_highres"], "int8 off ratio 2"),
    (["--resize-mode", "cubic", "--shard", "data=2", "--batch", "2"],
     "sharding requires bilinear resize"),
]


def _write(text: str):
    def corrupt(d):
        with open(os.path.join(d, "config"), "w") as f:
            f.write(text)
    return corrupt


# create_wrong_files.sh's cases, each applied to a copy of
# filters_2x/filters_highres
CORRUPT = {
    "wrongConfig_12": _write("12 3 3 11"),
    "wrongConfig_trunc": _write("24 3 3"),
    "wrongConfig_patch6": _write("24 3 3 6"),
    "noHashTable": lambda d: os.remove(os.path.join(d, "filterbin_2_8")),
    "noStrPath": lambda d: os.remove(os.path.join(d, "Qfactor_strbin_2_8")),
    "noCohPath": lambda d: os.remove(os.path.join(d, "Qfactor_cohbin_2_8")),
    "badHashNums": lambda d: os.rename(os.path.join(d, "filterbin_2_8"),
                                       os.path.join(d, "filterbin_6_8")),
}

# the folders a filters root holds: (folder, phases, bit depths); every
# folder has two passes, config "24 3 3 11"
FOLDERS = [
    ("filters_2x/filters_lowres", 4, (8, 10)),
    ("filters_2x/filters_highres", 4, (8, 10)),
    ("filters_2x/filters_denoise", 4, (8, 10)),
    ("filters_1.5x/filters_highres", 1, (8,)),
    ("filters_1.5x/filters_denoise", 1, (8,)),
]
# strength / coherence bin edges of the shape the shipped 2x banks use
QSTR = (0.001269, 0.022169)
QCOH = (0.192916, 0.405942)


def write_filter_folders(root: str, seed: int = 0) -> str:
    """Write FOLDERS under `root` in the reference's on-disk format: two
    passes of 216 buckets x phases x 121 taps each (centre tap 1 plus noise
    of 0.01), drawn from `seed`, for each bit depth. Returns `root`."""
    rng = np.random.default_rng(seed)
    for folder, phases, depths in FOLDERS:
        for bits in depths:
            banks = []
            for _ in range(2):
                filters = np.zeros((216 * phases, 128), np.float32)
                filters[:, :121] = rng.normal(size=(216 * phases, 121)).astype(np.float32) * 0.01
                filters[:, 60] += 1.0
                banks.append(FilterBank(filters=filters, qstr=np.asarray(QSTR, np.float32),
                                        qcoh=np.asarray(QCOH, np.float32), pixel_types=phases,
                                        taps=121, source_dtype="fp32"))
            save_filter_folder(os.path.join(root, folder), banks, bits=bits)
    return root


def make_clip(path: str, w: int = 32, h: int = 24, bits: int = 8, frames: int = 2) -> list:
    """A seeded YUV420 Y4M clip of uniform noise in the video range (10-bit:
    [64, 940)). Returns its frames."""
    wr = video.Y4MWriter(path, video.VideoFormat(w, h, bits, "420"))
    rng = np.random.default_rng(0)
    dt = np.uint8 if bits == 8 else np.uint16
    lo, hi = (16, 235) if bits == 8 else (64, 940)
    out = []
    for _ in range(frames):
        out.append(Frame(y=rng.integers(lo, hi, (h, w)).astype(dt),
                         u=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt),
                         v=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt)))
        wr.write(out[-1])
    wr.close()
    return out


def run_cli(args: list[str], main=cli_main) -> tuple[int, str, str]:
    """A CLI's `main` (raisr_tpu_torch.cli.main unless given) in process:
    (exit code, stdout, stderr). An argparse rejection gives its exit code;
    an exception the CLI does not handle gives 1 and the marker."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(args)
        except SystemExit as e:  # argparse rejections
            rc = int(e.code or 0)
        except Exception as e:  # noqa: BLE001
            err.write(f"{MARKER} unhandled: {e}\n")
            rc = 1
    return rc, out.getvalue(), err.getvalue()


def positive_rows(quick: bool = False) -> list[tuple]:
    """(folder, ratio, bits, passes, mode, blending, extra args) of the
    positive sweep; `quick` keeps the first three rows."""
    rows = [p + ([],) for p in (POSITIVE[:3] if quick else POSITIVE)]
    return rows if quick else rows + POSITIVE_EXTRA


def row_name(row) -> str:
    folder, ratio, bits, passes, mode, blending, extra = row
    return (f"{os.path.basename(folder)} r{ratio} b{bits} p{passes} m{mode} bl{blending} "
            f"{' '.join(extra)}").strip()


def shard_devices(row) -> int:
    """Devices a row's --shard asks for (data x rows), 1 without one."""
    extra = row[-1]
    if "--shard" not in extra:
        return 1
    spec = parse_shard_spec(extra[extra.index("--shard") + 1])
    return spec["data"] * spec["rows"]


def upscale_argv(row, root: str, src: str, dst: str, backend: str = "auto",
                 device: str | None = None) -> list[str]:
    """The `upscale` arguments of a positive row; without `device` the
    CLI's default (the card) serves it."""
    folder, ratio, bits, passes, mode, blending, extra = row
    argv = ["upscale", "-i", src, "-o", dst, "--filterfolder", os.path.join(root, folder),
            "--ratio", str(ratio), "--bits", str(bits), "--passes", str(passes),
            "--mode", str(mode), "--blending", str(blending), "--backend", backend]
    return argv + (["--device", device] if device else []) + list(extra)


def row_config(row, root: str, backend: str = "auto") -> RaisrConfig:
    """The RaisrConfig a positive row's flags name, built directly (not
    through the CLI's parser), for holding the CLI against the engine."""
    folder, ratio, bits, passes, mode, blending, extra = row

    def flag(name, default):
        return extra[extra.index(name) + 1] if name in extra else default

    return RaisrConfig(filterfolder=os.path.join(root, folder), ratio=ratio, bits=bits,
                       passes=passes, mode=mode, blending=BlendingMode(blending),
                       backend=backend, dtype=flag("--dtype", "float32"),
                       resize_mode=flag("--resize-mode", "bilinear"))


def clip_for(work: str, bits: int, w: int = 32, h: int = 24) -> str:
    """The sweep's input clip of `bits` under `work`, written once."""
    path = os.path.join(work, f"in_{bits}_{w}x{h}.y4m")
    if not os.path.exists(path):
        make_clip(path, w, h, bits)
    return path


def negative_cases(root: str, work: str, clip: str) -> list[tuple[list[str], str]]:
    """(full `upscale` argv, description) of every negative row: NEGATIVE_ARGS,
    a missing input and a directory as input."""
    base = ["upscale", "-i", clip, "-o", os.path.join(work, "neg.y4m"),
            "--filterfolder", os.path.join(root, "filters_2x/filters_lowres")]
    rows = NEGATIVE_ARGS + [(["-i", os.path.join(work, "missing.y4m")], "missing input"),
                            (["-i", work], "directory as input")]
    return [(base + [a.format(root=root) for a in extra], desc) for extra, desc in rows]


def corrupt_folder(root: str, work: str, name: str) -> str:
    """A copy of filters_2x/filters_highres under `work` with CORRUPT[name]
    applied."""
    d = os.path.join(work, f"bank_{name}")
    if os.path.exists(d):
        shutil.rmtree(d)
    shutil.copytree(os.path.join(root, "filters_2x/filters_highres"), d)
    CORRUPT[name](d)
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--filters-root", default=None,
                    help="directory holding filters_2x/ and filters_1.5x/ (default: "
                         "seeded folders written under the workdir)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="the CLI's --device for every run: cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="subset only")
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix="raisr_torch_sweep_")
    os.makedirs(work, exist_ok=True)
    root = args.filters_root or write_filter_folders(os.path.join(work, "filters"))
    failures = []
    n_pass = 0

    # a --shard row takes the first data x rows cards; the CPU any number
    # (the engine names it N times)
    n_dev = (torch.cuda.device_count() if torch.device(args.device).type == "cuda"
             else sys.maxsize)
    for row in positive_rows(args.quick):
        name, need = row_name(row), shard_devices(row)
        if need > 1 and need > n_dev:
            print(f"SKIP (needs {need} devices, {n_dev} visible): {name}")
            continue
        dst = os.path.join(work, "out.y4m")
        rc, out, err = run_cli(upscale_argv(row, root, clip_for(work, row[2]), dst,
                                            args.backend, args.device))
        if rc != 0 or MARKER in out + err:
            failures.append((name, rc, (out + err)[-300:]))
        else:
            n_pass += 1
            print(f"PASS {name}")

    clip = clip_for(work, 8)
    for cli_args, desc in negative_cases(root, work, clip):
        rc, out, err = run_cli(cli_args + ["--device", args.device])
        if rc == 0:
            failures.append((f"negative:{desc}", rc, "unexpectedly succeeded"))
        else:
            n_pass += 1
            print(f"PASS negative: {desc} (rc={rc})")

    for name in CORRUPT:
        rc, out, err = run_cli(
            ["upscale", "-i", clip, "-o", os.path.join(work, "neg.y4m"), "--filterfolder",
             corrupt_folder(root, work, name), "--device", args.device])
        if rc == 0 or MARKER not in out + err:
            failures.append((f"corrupt:{name}", rc, (out + err)[-200:]))
        else:
            n_pass += 1
            print(f"PASS corrupt model: {name}")

    print(f"\n{n_pass} passed, {len(failures)} failed")
    for name, rc, tail in failures:
        print(f"FAIL {name} rc={rc}: {tail}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
