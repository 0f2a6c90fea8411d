"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

Each kernel's wrapper sits beside its plain PyTorch version; the CUDA sources
are under raisr_tpu_torch/csrc/."""
