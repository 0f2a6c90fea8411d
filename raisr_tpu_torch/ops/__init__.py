from raisr_tpu_torch.ops.resize import bilinear_upscale, cheap_upscale
from raisr_tpu_torch.ops import hashing, census, filter_apply, pipeline

__all__ = [
    "bilinear_upscale",
    "cheap_upscale",
    "hashing",
    "census",
    "filter_apply",
    "pipeline",
]
