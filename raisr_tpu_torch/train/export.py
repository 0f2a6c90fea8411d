"""Write trained banks in the reference's on-disk model format.

Round-trips with raisr_tpu_torch.model.loader: the emitted folder is loadable by
both this framework and the reference library (binary filterbin layout per
ReadTrainedData, reference: Raisr.cpp:270-356; Qfactor text files :360-430;
config :1531-1578).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from raisr_tpu_torch.model.loader import FilterBank


def save_filterbin(path: str, bank: FilterBank, dtype: str = "fp32") -> None:
    taps = bank.taps
    weights = bank.filters[:, :taps]
    np_dtype = np.dtype("<f4") if dtype == "fp32" else np.dtype("<f2")
    with open(path, "wb") as f:
        f.write(dtype.encode("ascii"))
        f.write(struct.pack("<III", bank.hashkey_size, bank.pixel_types, taps))
        f.write(np.ascontiguousarray(weights, dtype=np_dtype).tobytes())


def save_qfactor(path: str, values: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(values):
            f.write(f"{float(v):.6f}\n")


def save_filter_folder(
    folder: str,
    banks: list[FilterBank],
    bits: int = 8,
    qangle: int = 24,
    qstrength: int = 3,
    qcoherence: int = 3,
    patch_size: int = 11,
    notes: str | None = None,
) -> None:
    """Write config + per-pass filterbin/Qfactor files for `bits`."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config"), "w") as f:
        f.write(f"{qangle} {qstrength} {qcoherence} {patch_size}")
    for pass_idx, bank in enumerate(banks):
        suffix = f"_{bits}" + ("_2" if pass_idx == 1 else "")
        save_filterbin(os.path.join(folder, f"filterbin_2{suffix}"), bank)
        save_qfactor(os.path.join(folder, f"Qfactor_strbin_2{suffix}"), bank.qstr)
        save_qfactor(os.path.join(folder, f"Qfactor_cohbin_2{suffix}"), bank.qcoh)
    if notes:
        with open(os.path.join(folder, "filternotes.txt"), "w") as f:
            f.write(notes)
