"""The plain reference agrees with the program's CPU path (its fused
backend's plain versions) at a tiny size, for every configuration that a
cell uses, on the batched step and on the per-frame entry point: each
against the reference module that its file names, as the harness's check
takes it."""

from __future__ import annotations

import importlib

import pytest
import torch
from conftest import config_file, configs

from gpubench import data
from gpubench.drivers.base import Context, program_engine
from gpubench.reference import raisr_plain


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("config", configs())
def test_reference_matches_the_program_on_the_cpu(config, seed):
    torch.set_num_threads(2)
    cfg = {**config_file(config), "height": 48, "width": 64, "backend": "pallas"}
    ref_mod = importlib.import_module(f"gpubench.reference.{cfg['reference']}")
    dev = torch.device("cpu")
    banks, qstr, qcoh = data.make_banks(cfg, seed, dev)
    y, u, v = data.make_frames(cfg, 3, seed, dev)
    ctx = Context(cfg, cfg, {}, dev, seed, banks, qstr, qcoh, (y, u, v))
    engine = program_engine(ctx)
    oy, ou, ov = engine.process_batch_device(y, u, v)
    ref = ref_mod.Reference(cfg, banks, qstr, qcoh)
    for i in range(3):
        want = ref.luma(y[i])
        assert ref_mod.compare(oy[i], want) == (0, 0.0)
        assert ref_mod.compare(ou[i], ref.chroma(u[i])) == (0, 0.0)
        assert ref_mod.compare(ov[i], ref.chroma(v[i])) == (0, 0.0)
        # the RAISR passes changed the frame: it is not the cheap upscale,
        # which is what `chroma` makes of a plane
        assert ref_mod.compare(want, ref.chroma(y[i]))[0] > 0
    from raisr_tpu_torch.engine import Frame

    one = engine.process(Frame(y=y[0].numpy(), u=u[0].numpy(), v=v[0].numpy()))
    assert ref_mod.compare(torch.from_numpy(one.y), ref.luma(y[0])) == (0, 0.0)


def test_compare_counts_a_changed_sample_and_a_wrong_shape():
    a = torch.full((4, 6), 100, dtype=torch.uint8)
    b = a.clone()
    b[1, 2] = 103
    assert raisr_plain.compare(a, b) == (1, 3.0)
    assert raisr_plain.compare(a, a[:, :5])[0] == 24


def test_packing_of_16_bit_planes():
    x = torch.tensor([[0.0, 940.0, 65535.0]])
    p = raisr_plain.pack(x, torch.uint16)
    assert p.dtype == torch.uint16
    assert raisr_plain.unpack(p).tolist() == x.tolist()
