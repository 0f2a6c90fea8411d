"""raisr_tpu_torch — the PyTorch/CUDA port of raisr_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same layout and public names.
Plain tensor code is PyTorch; the fused RAISR pass, a Pallas kernel in
raisr_tpu, is a CUDA C++ kernel for sm_90a here (csrc/full_kernel.cu), built
with nvcc at first use. This package never imports jax.

Public API (mirrors the reference's 5-function C API, Library/Raisr.h:14-33):
    RaisrConfig        — all knobs of the vf_raisr FFmpeg filter
    load_model         — filterbin/Qfactor/config parser (== RNLInit model load)
    RaisrEngine        — init once, process frames (== RNLInit/SetRes/Process)

File-to-file serving lives beside it, as in raisr_tpu: `stream.StreamProcessor`
(pipelined dispatch), `video` (Y4M / raw YUV / PNG), `io_native`, and the
`raisr-torch` command line (`cli.main`, `python -m raisr_tpu_torch.cli`).
"""

from raisr_tpu_torch.config import (
    RaisrConfig,
    BlendingMode,
    RangeType,
    RaisrError,
)
from raisr_tpu_torch.model.loader import load_model, FilterBank, RaisrModel
from raisr_tpu_torch.engine import RaisrEngine

__version__ = "1.0.0"

__all__ = [
    "RaisrConfig",
    "BlendingMode",
    "RangeType",
    "RaisrError",
    "load_model",
    "FilterBank",
    "RaisrModel",
    "RaisrEngine",
]
