"""Filter-bank model loader.

Parses the reference's on-disk model format bit-for-bit
(reference: Library/Raisr.cpp:187-433 `ReadTrainedData`/`VerifyTrainedData`,
config parse Raisr.cpp:1531-1578, path construction Raisr.cpp:1441-1474):

  <folder>/config                      — one line: "Qangle Qstrength Qcoherence patchSize"
  <folder>/filterbin_2_<bits>[_2]      — binary: 4-char dtype tag ("fp32"/"fp16"),
                                         u32 hashkeySize, u32 pixelTypes, u32 rows(=patch^2),
                                         then hashkeySize*pixelTypes filters of `rows`
                                         little-endian weights, row-major
  <folder>/Qfactor_strbin_2_<bits>[_2] — text: Qstrength-1 strength bin edges
  <folder>/Qfactor_cohbin_2_<bits>[_2] — text: Qcoherence-1 coherence bin edges

Filters are padded from rows=121 to aligned_rows=128 in one contiguous array,
keeping the reference's lane-friendly layout (Raisr.cpp:299,329).

The parser is numpy-only, as in raisr_tpu. `from_jax_model` converts a
raisr_tpu model held in memory, and `bank_tensors` puts a bank's arrays on a
torch device.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import warnings

import numpy as np
import torch

from raisr_tpu_torch.config import RaisrConfig, RaisrError, RaisrWarning


@dataclasses.dataclass(frozen=True)
class FilterBank:
    """One pass's trained data.

    filters: [hashkey_size * pixel_types, aligned_taps] float32, zero-padded
             past `taps`; row index = bucket * pixel_types + pixel_type
             (matches gFilterBuckets[hash][pixelType], Raisr.cpp:336-339).
    qstr/qcoh: strength / coherence bin edges (len Qstrength-1 / Qcoherence-1).
    """

    filters: np.ndarray
    qstr: np.ndarray
    qcoh: np.ndarray
    pixel_types: int
    taps: int
    source_dtype: str  # "fp32" | "fp16" as stored on disk

    @property
    def hashkey_size(self) -> int:
        return self.filters.shape[0] // self.pixel_types


@dataclasses.dataclass(frozen=True)
class RaisrModel:
    """Full loaded model: quantization config + one bank per pass."""

    qangle: int
    qstrength: int
    qcoherence: int
    patch_size: int
    banks: tuple[FilterBank, ...]  # len == passes

    @property
    def patch_margin(self) -> int:
        return self.patch_size >> 1  # gPatchMargin (Raisr.cpp:1573)

    @property
    def loop_margin(self) -> int:
        return (self.patch_size >> 1) + 1  # gLoopMargin (Raisr.cpp:1574)


def _stoi(token: str, config_path: str) -> int:
    """Mirror of RNLStoi (reference: Raisr.cpp:213-244): std::stoi semantics
    (parses a leading integer, rejects non-numeric / negative)."""
    token = token.strip()
    sign = 1
    i = 0
    if token[:1] in "+-":
        i = 1
    j = i
    while j < len(token) and token[j].isdigit():
        j += 1
    if j == i:
        raise RaisrError(f"configFile corrupted: {config_path}")
    value = int(token[:j])
    if value < 0:
        raise RaisrError(f"configFile corrupted: {config_path}")
    return value


def _verify_number_token(token: str, file_type: str, path: str) -> None:
    """Mirror of VerifyTrainedData (reference: Raisr.cpp:187-211)."""
    for c in token:
        # allowed chars: '-' .. '9' except '/'
        if c < "-" or c > "9" or c == "/":
            raise RaisrError(f"{file_type} corrupted: {path}")
    first_dot = token.find(".")
    if first_dot != token.rfind(".") or first_dot == 0:
        raise RaisrError(f"{file_type} corrupted: {path}")
    first_minus = token.find("-")
    if first_minus != -1 and first_dot != -1 and first_dot < first_minus:
        raise RaisrError(f"{file_type} corrupted: {path}")


def parse_config_file(config_path: str) -> tuple[int, int, int, int]:
    """Parse `config` ("24 3 3 11"; reference: Raisr.cpp:1531-1578)."""
    try:
        with open(config_path, "r") as f:
            line = f.readline()
    except OSError:
        raise RaisrError(f"Unable to open config file: {config_path}")
    tokens = line.split()
    if len(tokens) != 4:
        raise RaisrError(f"configFile corrupted: {config_path}")
    qangle = _stoi(tokens[0], config_path)
    qstrength = _stoi(tokens[1], config_path)
    qcoherence = _stoi(tokens[2], config_path)
    patch_size = _stoi(tokens[3], config_path)
    if patch_size != 11:
        # The reference only supports patchSize 11 (Raisr.cpp:1568-1572).
        raise RaisrError(f"configFile corrupted: {config_path}")
    return qangle, qstrength, qcoherence, patch_size


def _read_filterbin(
    path: str, qangle: int, qstrength: int, qcoherence: int, patch_size: int, ratio: float
) -> tuple[np.ndarray, int, int, str]:
    """Parse one filterbin file (reference: Raisr.cpp:260-358)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        raise RaisrError(f"Unable to load model: {path}")

    head_size = 4 + 3 * 4
    if len(raw) < head_size:
        raise RaisrError(f"hashtable corrupted: {path}")
    dtype_tag = raw[:4].decode("latin-1")
    if dtype_tag not in ("fp32", "fp16"):
        raise RaisrError(f"hashtable corrupted: {path}")
    # Intentional extension vs the reference: an fp16-tagged file loads on
    # any engine dtype (upconverted to f32), whereas the reference's f32
    # build rejects it via its sizeof(DT) size check (Raisr.cpp:335-356)
    # and only the FP16 build accepts it. One loader serving every
    # precision tier replaces per-ISA builds; documented in docs/PARITY.md.
    weight_size = 4 if dtype_tag == "fp32" else 2
    hashkey_size, pixel_types, rows = struct.unpack_from("<III", raw, 4)

    if (len(raw) - head_size) != hashkey_size * pixel_types * rows * weight_size:
        raise RaisrError(f"hashtable corrupted: {path}")
    if hashkey_size != qangle * qstrength * qcoherence:
        raise RaisrError("HashTable format is not compatible in number of hash keys!")
    if pixel_types != int(ratio) * int(ratio):
        raise RaisrError("HashTable format is not compatible in number of pixel types!")
    if patch_size % 2 == 0 or rows != patch_size * patch_size:
        raise RaisrError("HashTable format is not compatible in patch size!")

    np_dtype = np.dtype("<f4") if dtype_tag == "fp32" else np.dtype("<f2")
    weights = np.frombuffer(raw, dtype=np_dtype, offset=head_size).astype(np.float32)
    weights = weights.reshape(hashkey_size * pixel_types, rows)

    aligned_rows = 16 * ((rows + 15) // 16)  # Raisr.cpp:299
    filters = np.zeros((hashkey_size * pixel_types, aligned_rows), dtype=np.float32)
    filters[:, :rows] = weights
    return filters, pixel_types, rows, dtype_tag


def _read_qfactor(path: str, expected: int, file_type: str) -> np.ndarray:
    """Parse a Qfactor text file (reference: Raisr.cpp:360-430)."""
    try:
        with open(path, "r") as f:
            tokens = f.read().split()
    except OSError:
        raise RaisrError(f"Unable to load model: {path}")
    values = []
    for token in tokens:
        _verify_number_token(token, file_type, path)
        try:
            values.append(float(token))
        except ValueError:
            raise RaisrError(f"{file_type} corrupted: {path}")
    if len(values) != expected:
        raise RaisrError(f"{file_type} corrupted: {path}")
    return np.asarray(values, dtype=np.float32)


def load_model(folder: str, cfg: RaisrConfig) -> RaisrModel:
    """Load a filter folder per the RNLInit path logic (Raisr.cpp:1441-1594).

    Returns one FilterBank per pass (`_2`-suffixed files for pass 2).
    """
    if cfg.passes == 1 and cfg.mode == 2:
        warnings.warn(
            "[RAISR WARNING] 1 pass with upscale in 2d pass, mode = 2 ignored !",
            RaisrWarning,
        )

    bits_suffix = f"_{cfg.bits}"
    config_path = os.path.join(folder, "config")
    qangle, qstrength, qcoherence, patch_size = parse_config_file(config_path)

    banks = []
    for pass_idx in range(cfg.passes):
        pass_suffix = "_2" if pass_idx == 1 else ""
        filter_path = os.path.join(folder, f"filterbin_2{bits_suffix}{pass_suffix}")
        qstr_path = os.path.join(folder, f"Qfactor_strbin_2{bits_suffix}{pass_suffix}")
        qcoh_path = os.path.join(folder, f"Qfactor_cohbin_2{bits_suffix}{pass_suffix}")

        filters, pixel_types, taps, dtype_tag = _read_filterbin(
            filter_path, qangle, qstrength, qcoherence, patch_size, cfg.ratio
        )
        qstr = _read_qfactor(qstr_path, qstrength - 1, "StrFile")
        qcoh = _read_qfactor(qcoh_path, qcoherence - 1, "CohFile")
        banks.append(
            FilterBank(
                filters=filters,
                qstr=qstr,
                qcoh=qcoh,
                pixel_types=pixel_types,
                taps=taps,
                source_dtype=dtype_tag,
            )
        )

    return RaisrModel(
        qangle=qangle,
        qstrength=qstrength,
        qcoherence=qcoherence,
        patch_size=patch_size,
        banks=tuple(banks),
    )


def from_jax_model(m) -> RaisrModel:
    """Convert a raisr_tpu `RaisrModel` into this package's `RaisrModel`.

    Reads only the numpy fields (qangle, qstrength, qcoherence, patch_size and
    each bank's filters/qstr/qcoh/pixel_types/taps/source_dtype), so nothing of
    raisr_tpu or jax is imported. Arrays are copied as float32."""
    banks = tuple(
        FilterBank(
            filters=np.array(b.filters, dtype=np.float32),
            qstr=np.array(b.qstr, dtype=np.float32),
            qcoh=np.array(b.qcoh, dtype=np.float32),
            pixel_types=int(b.pixel_types),
            taps=int(b.taps),
            source_dtype=str(b.source_dtype),
        )
        for b in m.banks
    )
    return RaisrModel(
        qangle=int(m.qangle),
        qstrength=int(m.qstrength),
        qcoherence=int(m.qcoherence),
        patch_size=int(m.patch_size),
        banks=banks,
    )


def bank_tensors(
    model: RaisrModel, device: torch.device | str
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Per-pass (filters, qstr, qcoh) float32 tensors on `device`.

    filters is [hashkey_size * pixel_types, aligned_taps] (864 x 128 for a 2x
    bank), contiguous, as the fused kernel reads it."""
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=device)

    return (
        tuple(put(b.filters) for b in model.banks),
        tuple(put(b.qstr) for b in model.banks),
        tuple(put(b.qcoh) for b in model.banks),
    )
