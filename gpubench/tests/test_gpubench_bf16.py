"""The bf16 tier's configuration and cell (x2-bf16-resident): its reference's
frozen bank rounding against the program's, the exact check telling the
float32 and bfloat16 tiers apart at a tiny size on the CPU, and A2's
roofline (gather_roofline) against hand counts. The generic tests
(layout, faults, reference, control) take the cell up from BENCHMARK.json
on their own."""

from __future__ import annotations

import json
import types

import pytest
import torch
from conftest import ROOT, cells, config_file, configs
from test_gpubench_yardstick import synthetic_trace

from gpubench import calibrate, data, spec, yardstick
from gpubench.drivers.base import Context, program_engine
from gpubench.reference import raisr_plain, raisr_plain_bf16

CELL = "x2-bf16-resident"
BF16 = "raisr-2x-highres-2pass-bf16"
F32 = "raisr-2x-highres-2pass-f32"
SEEDS = [3, 2**31 + 5]


def _bank(seed: int) -> torch.Tensor:
    """A seeded [864, 128] float32 bank over a wide spread of magnitudes,
    so that many taps round and the carry crosses binades; taps 121..127
    hold noise that the rounding must not read."""
    g = torch.Generator().manual_seed(seed)
    bank = torch.randn((864, 128), generator=g) * 0.01
    bank[:, 60] += 1.0
    return bank * torch.empty((864, 1)).uniform_(0.01, 100, generator=g)


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_rounding_is_the_programs(seed):
    from raisr_tpu_torch.ops.cuda.full_kernel import round_bf16_error_diffused

    bank = _bank(seed)
    mine = raisr_plain_bf16.round_bf16_error_diffused(bank)
    program = round_bf16_error_diffused(bank)
    assert mine.dtype == torch.bfloat16 and tuple(mine.shape) == (864, 121)
    assert torch.equal(mine.view(torch.int16), program[:, :121].contiguous().view(torch.int16))
    # the rounding moved taps: the tier is not float32 under another name
    assert not torch.equal(mine.float(), bank[:, :121])


def _outputs(config: str, dtype: str, seed: int):
    """The program's batched step on 3 seeded 64x48 frames of `config` at
    `dtype`, on the CPU (its fused backend's plain versions), with the
    inputs it ran on."""
    torch.set_num_threads(2)
    cfg = {**config_file(config), "height": 48, "width": 64, "backend": "pallas",
           "dtype": dtype}
    dev = torch.device("cpu")
    banks, qstr, qcoh = data.make_banks(cfg, seed, dev)
    y, u, v = data.make_frames(cfg, 3, seed, dev)
    ctx = Context(cfg, cfg, {}, dev, seed, banks, qstr, qcoh, (y, u, v))
    return cfg, (banks, qstr, qcoh), y, program_engine(ctx).process_batch_device(y, u, v)[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ref_mod,program_dtype", [(raisr_plain, "bfloat16"),
                                                   (raisr_plain_bf16, "float32")],
                         ids=["f32-reference-bf16-program", "bf16-reference-f32-program"])
def test_the_check_tells_the_tiers_apart(ref_mod, program_dtype, seed):
    """Each tier's program against the other tier's reference differs; against
    its own it does not."""
    cfg, inputs, y, oy = _outputs(BF16, program_dtype, seed)
    own = raisr_plain_bf16 if program_dtype == "bfloat16" else raisr_plain
    differing = 0
    for i in range(y.shape[0]):
        assert own.compare(oy[i], own.Reference(cfg, *inputs).luma(y[i])) == (0, 0.0)
        differing += ref_mod.compare(oy[i], ref_mod.Reference(cfg, *inputs).luma(y[i]))[0]
    assert differing > 0


def test_reference_widens_the_rounded_bank():
    cfg = config_file(BF16)
    banks, qstr, qcoh = data.make_banks({**cfg, "height": 48, "width": 64}, 7,
                                        torch.device("cpu"))
    ref = raisr_plain_bf16.Reference(cfg, banks, qstr, qcoh)
    assert ref.banks.dtype == torch.float32 and tuple(ref.banks.shape) == (2, 864, 121)
    for p in range(2):
        assert torch.equal(ref.banks[p],
                           raisr_plain_bf16.round_bf16_error_diffused(banks[p]).float())
    assert raisr_plain_bf16.compare is raisr_plain.compare


def _gather():
    return spec.reader(ROOT, "gather_roofline").__globals__["gather_least_seconds"]


@pytest.mark.parametrize("config,want", [
    # 2 passes of 2160x3840; the dot's 242 operations a pixel at 67 TFLOP/s
    # (29.96 µs a plane) exceed its 9 bytes at 3.35 TB/s (22.28 µs)
    pytest.param(F32, 2 * 8_294_400 * 242 / 67e12, id=F32),
    # bf16: the operations at 989 TFLOP/s (2.03 µs) under the bytes
    pytest.param(BF16, 2 * 8_294_400 * 9 / 3.35e12, id=BF16),
    # 1.5x: one pass of 1620x2880, bound by operations (16.85 µs)
    pytest.param("raisr-1.5x-1pass-f32", 4_665_600 * 242 / 67e12, id="raisr-1.5x-1pass-f32"),
])
def test_gather_least_seconds_by_hand(config, want):
    assert _gather()(config_file(config), yardstick) == pytest.approx(want, rel=1e-12)


def test_gather_roofline_reads_a2_alone(tmp_path):
    """On the synthetic trace A2 ran 4 µs of its 8 frames: the share is A2's
    least time over those 4 µs, whatever A1 and B took; no trace, or no A2
    in it, reads nothing."""
    t = synthetic_trace(tmp_path, spec.kernel_groups(ROOT))
    t.units, t.frames = 2, 8
    cfg = config_file(BF16)
    run = types.SimpleNamespace(cfg=cfg, trace=t, yard=yardstick)
    read = spec.reader(ROOT, "gather_roofline")
    assert read(run) == pytest.approx(100 * 8 * _gather()(cfg, yardstick) * 1e6 / 4)
    t.device = [e for e in t.device if "gather" not in e.name]
    assert read(run) is None
    assert read(types.SimpleNamespace(cfg=cfg, trace=None, yard=yardstick)) is None


def test_the_cell_is_in_the_generic_lists():
    """The generic tests collect the cell and its configuration from
    BENCHMARK.json; its control is the int8 tier, stepped down from bf16,
    and it reports what x2-resident reports, and gather_roofline."""
    assert CELL in cells(pending=False) and CELL in cells({"batch_device"})
    assert BF16 in configs()
    cfg = config_file(BF16)
    assert "control" not in cfg
    assert calibrate.control_overrides(cfg) == {"dtype": "int8"}
    bench = spec.Bench(ROOT)
    cell, base = bench.cell(CELL), bench.cell("x2-resident")
    assert cell.chips == 1 and cell.traffic == base.traffic
    assert [m.name for m in cell.end_to_end] == [m.name for m in base.end_to_end]
    assert [m.name for m in cell.per_layer] == [m.name for m in base.per_layer]
    assert "gather_roofline" in [m.name for m in cell.per_layer]
    f32 = config_file(F32)
    assert {k for k in cfg if cfg[k] != f32[k]} == {"name", "vf_raisr", "deployment", "dtype",
                                                    "reference"}
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["configs"][-1]["reduced"] == []
