"""Structured logging with the reference's message conventions.

The reference logs raw `[RAISR ERROR]` / `[RAISR WARNING]` lines to stdout
(e.g. Raisr.cpp:194,266,1435) which its validation suite greps for
(test/validation_suite/run_tests_avxout.sh:169-179). We keep those prefixes
on top of standard python logging so both the sweep semantics and structured
logs work.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("raisr_tpu_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)


def info(msg: str):
    _logger.info(msg)


def warning(msg: str):
    _logger.warning(f"[RAISR WARNING] {msg}")


def error(msg: str):
    _logger.error(f"[RAISR ERROR] {msg}")


def to_stderr():
    """Route raisr_tpu_torch log output (incl. the init banner) to stderr — the
    CLI sets this when the output DATA stream goes to stdout (`-o -`), so
    the banner can't corrupt a piped Y4M stream."""
    for h in _logger.handlers:
        if isinstance(h, logging.StreamHandler):
            h.setStream(sys.stderr)


def banner(version: str):
    """Init banner (the reference prints lib version at RNLInit,
    Raisr.cpp:1418-1420)."""
    import torch

    info(f"RAISR-TPU [version]:\traisr_tpu_torch v{version}")
    if torch.cuda.is_available():
        info(f"device: {torch.cuda.get_device_name()}, "
             f"devices: {torch.cuda.device_count()}")
    else:
        info("device: cpu")
    info("-------------------------------------------")
