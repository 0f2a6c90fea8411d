"""setup_s: seconds from the start of run.py to the first timed frame:
imports, the CUDA context, the kernel library's load (its build in a
checkout's first run), banks, frames and warm-up."""


def read(run):
    return run.setup_s
