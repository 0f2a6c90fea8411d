from raisr_tpu_torch.utils import logging

__all__ = ["logging"]
