"""The benchmark's inputs, made from --seed on the run's device: filter banks
of the real shape and packed YUV420 frames. Both sides (the program and the
reference) get the same tensors.

Copied from chip_smoke.py's make_bank and make_planes and moved onto the
device: one torch.Generator on the device, a few large calls. Imports
nothing of the program.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

_SEED_MASK = (1 << 64) - 1


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one kind of input (`stream`), so banks and
    frames do not depend on each other's draws; any whole seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & _SEED_MASK)
    return g


def make_banks(cfg: dict, seed: int, device) -> tuple[torch.Tensor, list, list]:
    """[passes, buckets * pixel_types, 121] float32 taps: the centre tap 1
    plus normal noise of 0.01 at every tap; and each pass's strength and
    coherence edges as float32 values."""
    bank = cfg["bank"]
    rows = bank["qangle"] * bank["qstrength"] * bank["qcoherence"] * bank["pixel_types"]
    taps = bank["taps"]
    g = generator(seed, device, 1)
    banks = torch.randn((cfg["passes"], rows, taps), generator=g, device=device) * 0.01
    banks[..., taps // 2] += 1.0
    qstr = [np.asarray(bank["qstr"], np.float32)] * cfg["passes"]
    qcoh = [np.asarray(bank["qcoh"], np.float32)] * cfg["passes"]
    return banks, qstr, qcoh


def _planes(n: int, h: int, w: int, g: torch.Generator, device, lo: int, hi: int,
            dtype) -> torch.Tensor:
    """n packed planes of smooth content: coarse and fine noise bilinearly
    enlarged on the device, each plane stretched over [lo, hi]."""
    out = torch.zeros((n, 1, h, w), device=device)
    for scale, amp in ((32, 1.0), (4, 0.25)):
        noise = torch.randn((n, 1, h // scale + 1, w // scale + 1), generator=g, device=device)
        out += amp * F.interpolate(noise, size=(h, w), mode="bilinear", align_corners=False)
    lo_v = out.amin(dim=(1, 2, 3), keepdim=True)
    hi_v = out.amax(dim=(1, 2, 3), keepdim=True)
    out = (out - lo_v) / (hi_v - lo_v)
    vals = torch.round(lo + out[:, 0] * (hi - lo))
    if dtype == torch.uint16:  # written through int32 and an int16 view
        return vals.to(torch.int32).to(torch.int16).view(torch.uint16)
    return vals.to(dtype)


def make_frames(cfg: dict, n: int, seed: int, device) -> tuple:
    """n distinct packed YUV420 frames: (Y [n, H, W], U, V [n, H/2, W/2]),
    uint8 over the video range at 8 bits, uint16 at 10, uint16 over the
    full range at 16."""
    bits = cfg["bits"]
    lo, hi = {8: (16, 235), 10: (64, 940), 16: (0, 65535)}[bits]
    dtype = torch.uint8 if bits == 8 else torch.uint16
    h, w = cfg["height"], cfg["width"]
    g = generator(seed, device, 2)
    y = _planes(n, h, w, g, device, lo, hi, dtype)
    u = _planes(n, h // 2, w // 2, g, device, lo, hi, dtype)
    v = _planes(n, h // 2, w // 2, g, device, lo, hi, dtype)
    return y, u, v


def write_bank_folder(folder: str, cfg: dict, banks: torch.Tensor, qstr, qcoh) -> None:
    """The upstream on-disk filter folder of the banks (`config`, a binary
    fp32 `filterbin_2_<bits>[_2]` and text Qfactor files a pass), for an
    entry point that loads its bank from a folder."""
    bank = cfg["bank"]
    bits = cfg["bits"]
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config"), "w") as f:
        f.write(f"{bank['qangle']} {bank['qstrength']} {bank['qcoherence']} "
                f"{bank['patch_size']}")
    host = banks.detach().to("cpu", torch.float32).numpy()
    buckets = bank["qangle"] * bank["qstrength"] * bank["qcoherence"]
    for p in range(cfg["passes"]):
        suffix = f"_{bits}" + ("_2" if p == 1 else "")
        with open(os.path.join(folder, f"filterbin_2{suffix}"), "wb") as f:
            f.write(b"fp32")
            f.write(struct.pack("<III", buckets, bank["pixel_types"], bank["taps"]))
            f.write(np.ascontiguousarray(host[p], dtype="<f4").tobytes())
        for name, values in (("strbin", qstr[p]), ("cohbin", qcoh[p])):
            with open(os.path.join(folder, f"Qfactor_{name}_2{suffix}"), "w") as f:
                f.writelines(f"{float(v):.6f}\n" for v in values)
