"""The port's multi-device paths (raisr_tpu_torch.parallel.sharding, the
engine's shard=, the stream over a sharded engine, train_step_sharded) on
the CPU, over meshes that name the CPU device several times.

Data-parallel and row-striped outputs must equal the port's unsharded
pipeline bit for bit, at every backend, tier, ratio and two-pass mode: the
halo covers the whole pass's support, zones and pixel phases use global rows,
and the striped resize does the whole-plane resize's arithmetic. The fused
backend runs its plain version here. On taps the port is also held against
raisr_tpu's *unsharded* pipeline and its process_batch_2d on the virtual
8-device CPU mesh (tests/conftest.py) at the cross-backend bar (under 2% of
pixels differ, median 0); never against raisr_tpu's stripes of the fused
kernel (ROADMAP C2). Planes are tens of rows; the file takes about 40 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raisr_tpu.ops.pipeline import pass_statics as jax_pass_statics
from raisr_tpu.ops.pipeline import process_plane_y as jax_process_plane_y
from raisr_tpu.parallel import sharding as js
from raisr_tpu.train import trainer as jt
import raisr_tpu.config as jcfg
from raisr_tpu_torch import RaisrConfig, RaisrEngine, RaisrError
from raisr_tpu_torch.engine import Frame, parse_shard_spec
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.pipeline import process_plane_y, process_plane_y_batch
from raisr_tpu_torch.ops.resize import cheap_upscale
from raisr_tpu_torch.parallel import sharding as ps
from raisr_tpu_torch.parallel import make_mesh
from raisr_tpu_torch.stream import StreamProcessor
from raisr_tpu_torch.train import train_step_sharded
from raisr_tpu_torch.train import trainer as pt
from test_torch_train import BANK_TOL, CT_TOL, LAM, _provisional, make_pairs
from torch_port_util import frac_and_median, hash_agreement, make_jax_model, smooth

CPU = torch.device("cpu")
FUZZ_FRAC = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: planes of tens of rows gain nothing from more,
    and under pytest-xdist's workers the threads of every worker
    oversubscribe the cores (these tests then ran ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n, axes=("data", "rows")):
    return make_mesh(n, axes, devices=[CPU] * n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for pt_, seed in ((4, 31), (1, 32)):
        jm = make_jax_model(passes=2, seed=seed, pixel_types=pt_)
        out[pt_] = (jm, from_jax_model(jm))
    return out


# -- the mesh and the shard spec ------------------------------------------


def test_make_mesh_shapes():
    assert cpu_mesh(8).shape == {"data": 4, "rows": 2}
    assert cpu_mesh(4).shape == {"data": 2, "rows": 2}
    assert cpu_mesh(2).shape == {"data": 2, "rows": 1}
    assert cpu_mesh(3).shape == {"data": 3, "rows": 1}
    assert cpu_mesh(4, ("rows",)).shape == {"rows": 4}
    # JAX's shape rule on the same counts
    for n in (2, 4, 8):
        assert tuple(js.make_mesh(n).shape.values()) == tuple(cpu_mesh(n).shape.values())
    mesh = cpu_mesh(8)
    assert mesh.distinct() == [CPU]
    assert mesh.grid("rows", "data").shape == (2, 4)
    assert list(mesh.grid("data")) == [CPU] * 4
    with pytest.raises(ValueError, match="requested"):
        make_mesh(4, devices=[CPU] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested"):
            make_mesh(2)  # the cards are the default, and there is none


def test_engine_shard_spec_parsing():
    assert parse_shard_spec(None) == {"data": 1, "rows": 1}
    assert parse_shard_spec("data=4") == {"data": 4, "rows": 1}
    assert parse_shard_spec("data=2,rows=2") == {"data": 2, "rows": 2}
    assert parse_shard_spec(" rows=8 ") == {"data": 1, "rows": 8}
    for bad in ("data", "cols=2", "data=x", "data=0"):
        with pytest.raises(RaisrError):
            parse_shard_spec(bad)


def test_pixel_types_row0_is_the_frames_phase():
    from raisr_tpu_torch.ops.hashing import pixel_types

    whole = pixel_types(20, 6, 2, 5, True)
    for row0 in (-8, -3, 4, 7):
        part = pixel_types(6, 6, 2, 5, True, row0=row0)
        assert torch.equal(part, torch.cat([whole, whole])[row0 % 2: row0 % 2 + 6])


# -- striped and data-parallel outputs against the unsharded pipeline -------


CASES = {  # id: (RaisrConfig kwargs, pixel types of the bank)
    "taps-cobc": (dict(backend="reference", passes=1), 4),
    "taps-randomness": (dict(backend="reference", passes=1, blending=1), 4),
    "taps-2pass-mode1": (dict(backend="reference", passes=2), 4),
    "taps-2pass-mode2": (dict(backend="reference", passes=2, mode=2), 4),
    "taps-1.5x": (dict(backend="reference", passes=1, ratio=1.5), 1),
    "fused-f32-randomness": (dict(backend="pallas", passes=1, blending=1), 4),
    "fused-f32-2pass-mode1": (dict(backend="pallas", passes=2), 4),
    "fused-f32-2pass-mode2": (dict(backend="pallas", passes=2, mode=2), 4),
    "fused-f32-1.5x": (dict(backend="pallas", passes=2, ratio=1.5), 1),
    "fused-bf16": (dict(backend="pallas", passes=2, dtype="auto"), 4),
    "fused-pcenter-10bit": (dict(backend="pallas", passes=2, dtype="bfloat16", bits=10), 4),
    "fused-int8": (dict(backend="pallas", passes=2, dtype="int8"), 4),
    "fused-single-bf16-10bit": (
        dict(backend="pallas", passes=1, ratio=1.5, dtype="bfloat16", bits=10), 1),
}
# (LR height, width): 4 stripes of 8 LR rows at 2x and 1.5x
LR_H, LR_W = 32, 36


def _engine(models, case):
    kw, pt_ = CASES[case]
    return RaisrEngine(RaisrConfig(**kw), models[pt_][1], device="cpu")


def _planes(n, bits, seed):
    return torch.stack([torch.tensor(smooth(LR_H, LR_W, bits, seed + i)) for i in range(n)])


@pytest.mark.parametrize("layout", ["rows", "dp", "2d"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_unsharded(models, case, layout):
    eng = _engine(models, case)
    s, cfg = eng._statics, eng.cfg
    out_h, out_w = cfg.output_size(LR_H, LR_W)
    args = (eng._filters, s, cfg.passes, cfg.two_pass_mode, out_h, out_w)
    banks = {CPU: eng._filters}
    if s.backend == "pallas":
        assert s.tier == {"fused-bf16": "bfloat16", "fused-pcenter-10bit": "pcenter",
                          "fused-int8": "int8", "fused-single-bf16-10bit": "bfloat16"
                          }.get(case, "float32")
    if layout == "rows":
        lr = _planes(1, cfg.bits, 3)[0]
        got = ps.process_plane_row_sharded(lr, banks, *args[1:],
                                           cpu_mesh(4, ("rows",)))
        want = process_plane_y(lr, *args)
    else:
        batch = _planes(4, cfg.bits, 7)
        if layout == "dp":
            got = ps.process_batch_dp(batch, banks, *args[1:], cpu_mesh(4, ("data",)))
        else:
            got = ps.process_batch_2d(batch, banks, *args[1:], cpu_mesh(4))
        want = process_plane_y_batch(batch, *args)
    assert got.shape == want.shape and got.device == CPU
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("lr_h,out_h,lr_w,out_w", [
    (32, 64, 36, 72), (32, 48, 36, 54), (32, 56, 36, 63)], ids=["2x", "1.5x", "1.75x"])
def test_upscale_stripe_equals_cheap_upscale(lr_h, out_h, lr_w, out_w):
    """The striped resize's core rows, stripe by stripe, against the whole
    plane's: the exact-integer forms (2x against the slice form, 1.5x) and
    the float form (1.75x) alike, bit for bit, at 8 and 10 bits."""
    n = 4
    for bits in (8, 10):
        lr = torch.tensor(smooth(lr_h, lr_w, bits, seed=bits))
        lr_halo = ps._lr_halo(lr_h, out_h)
        stripes = ps._exchange_halo(list(lr.split(lr_h // n)), lr_halo)
        hs = out_h // n
        got = torch.cat([
            ps._upscale_stripe(e, lr_halo, hs, ps.HR_HALO, out_w, out_h, bits, lr_h, i,
                               lr_h // n)[ps.HR_HALO: ps.HR_HALO + hs]
            for i, e in enumerate(stripes)])
        assert torch.equal(got, cheap_upscale(lr, out_h, out_w, bits)), bits


def test_exchange_halo_replicates_the_frame_edges():
    x = torch.arange(24, dtype=torch.float32).reshape(12, 2)
    ext = ps._exchange_halo(list(x.split(4)), 2)
    assert torch.equal(ext[0][:2], x[:1].expand(2, 2))
    assert torch.equal(ext[1], x[2:10])
    assert torch.equal(ext[2][-2:], x[-1:].expand(2, 2))


# -- on taps, against raisr_tpu's unsharded pipeline and its 2-D step -------


def test_taps_against_jax(models):
    jm, tm = models[4]
    cfg = RaisrConfig(backend="reference", passes=2)
    eng = RaisrEngine(cfg, tm, device="cpu")
    js_ = jax_pass_statics(jcfg.RaisrConfig(backend="reference", passes=2), jm, "taps")
    banks = [tuple(jnp.asarray(getattr(b, k)) for b in jm.banks)
             for k in ("filters", "qstr", "qcoh")]
    batch = _planes(4, 8, 11)
    out_h, out_w = 2 * LR_H, 2 * LR_W
    port_2d = ps.process_batch_2d(batch, eng._banks, eng._statics, 2, 1, out_h, out_w,
                                  cpu_mesh(4))
    port_rows = ps.process_plane_row_sharded(batch[0], eng._banks, eng._statics, 2, 1,
                                             out_h, out_w, cpu_mesh(4, ("rows",)))
    jax_2d = np.asarray(js.process_batch_2d(jnp.asarray(batch.numpy()), *banks, js_, 2, 1,
                                            out_h, out_w, js.make_mesh(4)))
    for i in range(4):
        jax_whole = np.asarray(jax_process_plane_y(jnp.asarray(batch[i].numpy()), *banks, js_,
                                                   2, 1, out_h, out_w))
        for got, want in ((port_2d[i].numpy(), jax_whole), (port_2d[i].numpy(), jax_2d[i])):
            frac, med = frac_and_median(got, want)
            assert frac < FUZZ_FRAC and med == 0.0, (i, frac, med)
    frac, med = frac_and_median(port_rows.numpy(), jax_2d[0])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


# -- the engine ------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("spec", ["data=4", "data=2,rows=2", "rows=4"])
def test_engine_shard_matches_unsharded(models, spec, backend):
    _, tm = models[4]
    cfg = RaisrConfig(passes=2, backend=backend)
    base = RaisrEngine(cfg, tm, device="cpu")
    eng = RaisrEngine(cfg, tm, shard=spec, device="cpu")
    shard = parse_shard_spec(spec)
    assert eng._mesh.shape == shard and eng._mesh.distinct() == [CPU]
    batch = torch.from_numpy(np.stack([smooth(24, 28, seed=40 + i) for i in range(4)]))
    assert torch.equal(eng.process_batch_y(batch), base.process_batch_y(batch))
    assert torch.equal(eng.upscale_y(batch[0]), base.upscale_y(batch[0]))
    u = torch.full((4, 12, 14), 128, dtype=torch.uint8)
    for a, b in zip(eng.process_batch_device(batch.to(torch.uint8), u, u),
                    base.process_batch_device(batch.to(torch.uint8), u, u)):
        assert torch.equal(a, b)


def test_engine_shard_errors(models, monkeypatch):
    _, tm = models[4]
    cfg = RaisrConfig(passes=1)
    eng = RaisrEngine(cfg, tm, shard="data=4", device="cpu")
    with pytest.raises(RaisrError, match="divisible"):
        eng.process_batch_y(torch.zeros((6, 20, 28)))
    eng2 = RaisrEngine(cfg, tm, shard="rows=4", device="cpu")
    with pytest.raises(RaisrError, match="stripe"):
        eng2.upscale_y(torch.zeros((30, 28)))  # 30/4 not integral
    with pytest.raises(RaisrError, match="stripe"):
        eng2.upscale_y(torch.zeros((16, 28)))  # LR stripes of 4 rows, a halo of 6
    with pytest.raises(RaisrError, match="stripe"):  # mode 2: LR stripes of 6 rows at LR
        RaisrEngine(RaisrConfig(passes=2, mode=2, backend="pallas"), tm, shard="rows=4",
                    device="cpu").upscale_y(torch.zeros((24, 28)))
    with pytest.raises(RaisrError, match="bilinear"):
        RaisrEngine(RaisrConfig(resize_mode="lanczos"), tm, shard="rows=2", device="cpu")
    # one card visible: a mesh of two cannot be built (no CUDA memory is touched)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")  # the init banner
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RaisrError, match="needs 2 devices but only 1 are visible"):
        RaisrEngine(cfg, tm, shard="data=2", device="cuda")


def test_fused_pass_refuses_an_odd_stripe_start(models):
    eng = _engine(models, "fused-f32-2pass-mode1")
    from raisr_tpu_torch.ops.pipeline import raisr_pass

    with pytest.raises(ValueError, match="row0"):
        raisr_pass(torch.zeros((24, 28)), eng._filters[0], eng._statics, row0=-7, zone_h=40)


# -- the stream over a sharded engine ------------------------------------------


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [Frame(y=smooth(24, 32, seed=seed + i).astype(np.uint8),
                  u=rng.integers(16, 240, (12, 16)).astype(np.uint8),
                  v=rng.integers(16, 240, (12, 16)).astype(np.uint8)) for i in range(n)]


@pytest.mark.parametrize("spec,batch,n", [("data=2", 1, 3), ("rows=2", 1, 3),
                                          ("data=2", 4, 6), ("data=2,rows=2", 4, 6)])
def test_stream_over_sharded_engine(models, spec, batch, n):
    """Batch 1 goes frame by frame through the per-plane entry points; batch
    4 on 6 frames pads the tail group of 2 to 4, which the data axis
    divides. Every frame equals the unsharded engine's process."""
    _, tm = models[4]
    cfg = RaisrConfig(passes=2, backend="pallas")
    eng = RaisrEngine(cfg, tm, shard=spec, device="cpu")
    base = RaisrEngine(cfg, tm, device="cpu")
    frames = _frames(n, 50)
    got = list(StreamProcessor(eng, depth=2, batch=batch).process(iter(frames)))
    assert len(got) == n
    for f, g in zip(frames, got):
        want = base.process(f)
        for a, b in ((g.y, want.y), (g.u, want.u), (g.v, want.v)):
            assert a.dtype == np.uint8 and np.array_equal(a, b)


# -- train_step_sharded ------------------------------------------------------------


@pytest.fixture(scope="module")
def train_setup():
    jc, tc = jt.TrainConfig(lam=LAM, chunk=512), pt.TrainConfig(lam=LAM, chunk=512)
    pairs = make_pairs(4, 2.0, 8, seed=61)
    lr = np.stack([p[0] for p in pairs]).astype(np.float32)
    hr = np.stack([p[1] for p in pairs]).astype(np.float32)
    rows, flipped = hash_agreement(pairs, jc, tc)
    f0 = _provisional(tc.num_filters)
    jmesh = js.make_mesh(4, ("data",))
    jax_banks = {
        ct: np.asarray(jt.train_step_sharded(
            jnp.asarray(lr), jnp.asarray(hr), jc, jmesh,
            ct_filters=jnp.asarray(f0) if ct else None))
        for ct in (False, True)}
    return dict(pairs=pairs, lr=torch.tensor(lr), hr=torch.tensor(hr), tc=tc, rows=rows,
                flipped=flipped, f0=torch.tensor(f0), jax=jax_banks)


@pytest.mark.parametrize("ct", [False, True], ids=["plain", "ct"])
def test_train_step_sharded(train_setup, ct):
    t = train_setup
    mesh = cpu_mesh(4, ("data",))
    f0 = t["f0"] if ct else None
    bank = train_step_sharded(t["lr"], t["hr"], t["tc"], mesh, ct_filters=f0)
    again = train_step_sharded(t["lr"], t["hr"], t["tc"], mesh, ct_filters=f0)
    assert torch.equal(bank, again)  # a fixed order of sums
    assert bank.shape == (t["tc"].num_filters, 128)
    # against raisr_tpu's sharded step, on the filters whose pixels hashed alike
    assert t["flipped"] < FUZZ_FRAC, t["flipped"]
    np.testing.assert_allclose(bank.numpy()[t["rows"]], t["jax"][ct][t["rows"]],
                               **(CT_TOL if ct else BANK_TOL))
    # against the port's one-device sums over the same pairs
    if ct:
        q, v = pt.init_accumulators(t["tc"])
        for lr, hr in t["pairs"]:
            lr_t, hr_t = (torch.tensor(a.astype(np.float32)) for a in (lr, hr))
            pt.accumulate_pair_ct(q, v, pt._cheap(lr_t, hr_t, t["tc"]), hr_t, f0, t["tc"], 2)
        want = pt.solve_filters(q, v, t["tc"]).numpy()
    else:
        want = pt.train_filterbank(t["pairs"], t["tc"], device="cpu").filters
    np.testing.assert_allclose(bank.numpy(), want, **BANK_TOL)
