"""The work of the algorithm, counted from the configuration's shapes, and the
card's peaks: what the mfu and roofline metrics divide by.

Copied from chip_smoke.py (HBM_BYTES_PER_S, PEAK_OPS_PER_S, DOT_OPS,
HASH_OPS, bound) and completed: the count covers the hash as well as the
dot, so it reads the same whichever kernels do the work. Imports nothing of
the program.
"""

from __future__ import annotations

# An H100 SXM's device memory rate and dense peak rates (NVIDIA's data
# sheet, at the full 700 W): float32 outside the tensor cores, bfloat16 and
# int8 in them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# a pixel's 121-tap dot: one multiply and one add a tap
DOT_OPS = 2 * 121
# the hash's float operations a pixel: 2 gradients, 3 products, the 11-tap
# vertical and horizontal sums of 3 maps (2 * 3 * 11 * 2), 3 scalings and
# ~30 of eigen-analysis, atan2 and binning
HASH_OPS = 170
PASS_OPS = DOT_OPS + HASH_OPS


def sample_bytes(cfg: dict) -> int:
    return 1 if int(cfg["bits"]) == 8 else 2


def frame_shapes(cfg: dict) -> dict:
    """LR and output sizes of the Y plane and of one YUV420 chroma plane."""
    h, w = int(cfg["height"]), int(cfg["width"])
    r = float(cfg["ratio"])
    return {"y_in": (h, w), "y_out": (int(h * r), int(w * r)),
            "c_in": (h // 2, w // 2), "c_out": (int(h // 2 * r), int(w // 2 * r))}


def pass_planes(cfg: dict) -> list[tuple[int, int]]:
    """The plane each pass of Y runs over: every pass at the output size in
    mode 1; in two-pass mode 2 the first pass at the input size."""
    s = frame_shapes(cfg)
    passes, mode = int(cfg["passes"]), int(cfg["mode"])
    return [s["y_in"] if (passes == 2 and mode == 2 and i == 0) else s["y_out"]
            for i in range(passes)]


def frame_ops(cfg: dict) -> int:
    """Operations of one frame: the dot and the hash at every pixel of every
    pass. Chroma's bilinear upscale (a few operations an output sample) is
    left out."""
    return sum(h * w * PASS_OPS for h, w in pass_planes(cfg))


def glue_bytes(cfg: dict) -> int:
    """Bytes of the glue of one frame: the packed Y, U and V in once, pass
    1's float32 input plane and the packed U and V out once."""
    s = frame_shapes(cfg)
    b = sample_bytes(cfg)
    (h, w), (ch, cw), (coh, cow) = s["y_in"], s["c_in"], s["c_out"]
    first = pass_planes(cfg)[0]
    return h * w * b + 2 * ch * cw * b + first[0] * first[1] * 4 + 2 * coh * cow * b


def peak_ops(cfg: dict) -> float:
    """The peak rate of the precision the configuration states."""
    return PEAK_OPS_PER_S[cfg["dtype"]]


def least_seconds(ops: float, nbytes: float, op_type: str) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type, and which
    of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[op_type]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pass_least_seconds(cfg: dict) -> float:
    """The least time of the passes of one frame, pass by pass: each reads
    its float32 plane once and writes its float32 output once (the bank,
    read once a launch and not once a frame, is left out: under 1% of a
    1080p frame's bytes)."""
    total = 0.0
    for h, w in pass_planes(cfg):
        total += least_seconds(h * w * PASS_OPS, h * w * 8, cfg["dtype"])[0]
    return total


def glue_least_seconds(cfg: dict) -> float:
    return glue_bytes(cfg) / HBM_BYTES_PER_S
