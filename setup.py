from setuptools import setup, Extension

setup(
    ext_modules=[
        Extension(
            "raisr_tpu._raisrio",
            sources=["raisr_tpu/native/raisrio.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,  # framework falls back to numpy implementations
        ),
        Extension(
            "raisr_tpu_torch._raisrio",
            sources=["raisr_tpu_torch/native/raisrio.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,  # the port falls back to numpy implementations too
        ),
    ]
)
