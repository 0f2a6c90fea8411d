from raisr_tpu_torch.utils.metrics import psnr, ssim
from raisr_tpu_torch.utils.profiler import Tracer, device_fence
from raisr_tpu_torch.utils import logging

__all__ = ["psnr", "ssim", "Tracer", "device_fence", "logging"]
