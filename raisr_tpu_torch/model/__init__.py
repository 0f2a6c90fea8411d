from raisr_tpu_torch.model.loader import (
    load_model,
    FilterBank,
    RaisrModel,
    from_jax_model,
    bank_tensors,
)
from raisr_tpu_torch.model.gaussian import gaussian_weights, GAUSSIAN_11x11

__all__ = [
    "load_model",
    "FilterBank",
    "RaisrModel",
    "from_jax_model",
    "bank_tensors",
    "gaussian_weights",
    "GAUSSIAN_11x11",
]
