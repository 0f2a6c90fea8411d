"""The CUDA pass's limits as plain functions, held on the CPU: the hash's
bucket and edge limits (ops/cuda/filter_kernel.py check_bank_limits), the
engine's refusal of a bank over them at construction on a CUDA device, the
shared-memory size rule of apply_filters (gather_smem_bytes,
check_gather_smem), the hash launch's count of interior and edge tiles
(hash_tile_counts) with its wrapper on the CPU (hash_buckets), and the
gather launch's count of shared-memory wavefronts (gather_wavefronts,
bank_slots) with its wrapper on the CPU (gather_buckets). raisr_tpu has
no such limits (its loader and kernels take any qangle x qstrength x
qcoherence), so the CPU and the taps backend must go on taking those banks,
as raisr_tpu does.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.config import RaisrConfig as JConfig
from raisr_tpu.engine import RaisrEngine as JEngine
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.config import RaisrError
from raisr_tpu_torch.engine import check_cuda_bank
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import filter_kernel as flk
from torch_port_util import frac_and_median, make_filters, smooth


def _jax_model(qangle, qstrength, qcoherence, seed=0):
    """A one-pass 4-phase raisr_tpu model of qangle x qstrength x qcoherence
    buckets, with evenly spaced edges."""
    from raisr_tpu.model.loader import FilterBank, RaisrModel

    bank = FilterBank(
        filters=make_filters(np.random.default_rng(seed), 4, qangle * qstrength * qcoherence),
        qstr=np.linspace(0.001, 0.03, qstrength - 1).astype(np.float32),
        qcoh=np.linspace(0.15, 0.6, qcoherence - 1).astype(np.float32),
        pixel_types=4, taps=121, source_dtype="fp32")
    return RaisrModel(qangle=qangle, qstrength=qstrength, qcoherence=qcoherence,
                      patch_size=11, banks=(bank,))


@pytest.mark.parametrize("dims,edges,match", [
    ((24, 3, 3), (2, 2), None),
    ((16, 4, 4), (3, 3), None),  # 256 buckets: the most one byte holds
    ((2, 9, 9), (8, 8), None),  # 8 edges each: the most the hash launch takes
    ((25, 4, 3), (3, 2), "at most 256 buckets, got 25 x 4 x 3 = 300"),
    ((257, 1, 1), (0, 0), "at most 256 buckets"),
    ((0, 3, 3), (2, 2), "at most 256 buckets"),
    ((2, 10, 3), (9, 2), "at most 8 strength and 8 coherence edges, got 9 and 2"),
    ((2, 3, 10), (2, 9), "at most 8 strength and 8 coherence edges, got 2 and 9"),
])
def test_check_bank_limits(dims, edges, match):
    if match is None:
        flk.check_bank_limits(*dims, *edges)
        return
    with pytest.raises(ValueError, match=match):
        flk.check_bank_limits(*dims, *edges)
    # the kernel wrappers' builder of the hash's arguments runs the same check
    k1d = (0.0,) * 11
    with pytest.raises(ValueError, match=match):
        flk._hash_launch_args(k1d, 1.0, (0.0,) * edges[0], (0.0,) * edges[1], *dims)


@pytest.mark.parametrize("dims,match", [
    ((25, 4, 3), "pass 1: .*at most 256 buckets, got 25 x 4 x 3 = 300"),
    ((2, 11, 3), "pass 1: .*at most 8 strength and 8 coherence edges, got 10 and 2"),
])
def test_engine_refuses_bank_over_cuda_limits_at_construction(monkeypatch, dims, match):
    """On a CUDA device (its availability check stubbed: there is no card
    here) the fused backend refuses the bank when the engine is built, before
    any tensor moves; nothing falls back to taps or to the CPU."""
    tm = from_jax_model(_jax_model(*dims))
    with pytest.raises(RaisrError, match=match):
        check_cuda_bank(tm)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")  # the init banner
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("auto", "pallas"):
        with pytest.raises(RaisrError, match=match):
            RaisrEngine(RaisrConfig(passes=1, backend=backend), tm, device="cuda")


def test_cpu_and_taps_take_a_bank_over_the_limits():
    """300 buckets: the taps backend and the fused backend's plain version
    serve it on the CPU, within raisr_tpu's cross-backend bar (under 2% of
    pixels differ, median 0) of raisr_tpu's own engine on the same bank."""
    jm = _jax_model(25, 4, 3, seed=1)
    tm = from_jax_model(jm)
    y = smooth(24, 32, seed=2)
    ref = np.asarray(JEngine(JConfig(passes=1, backend="reference"), jm).upscale_y(jnp.asarray(y)))
    for backend in ("reference", "pallas"):
        eng = RaisrEngine(RaisrConfig(passes=1, backend=backend), tm, device="cpu")
        out = eng.upscale_y(torch.from_numpy(y)).numpy()
        frac, med = frac_and_median(out, ref)
        assert out.shape == (48, 64) and frac < 0.02 and med == 0.0, (backend, frac, med)


@pytest.mark.parametrize("pixel_types,tiles", [(4, 86_432), (1, 28_224)])
@pytest.mark.parametrize("n_buckets", [1, 216, 256])
def test_gather_smem_bytes_fits(n_buckets, pixel_types, tiles):
    """The phase's float32 rows at 496 bytes (31 16-byte groups) and two tile
    buffers for each of 2 groups: 73 x 74 words (4 phases) or 42 x 42 (1)."""
    assert tiles == 4 * 4 * (73 * 74 if pixel_types == 4 else 42 * 42)
    need = flk.gather_smem_bytes(n_buckets, pixel_types)
    assert need == n_buckets * 496 + tiles
    assert need <= flk.MAX_SMEM_BYTES
    flk.check_gather_smem(n_buckets, pixel_types)


def test_gather_smem_bytes_of_the_fused_pass():
    """The rule gives the sizes A2's 216-bucket forms ask for: apply_filters'
    float32 launch over int buckets, and each tier's form over the hash's
    uint8 buckets, with its 256-byte slot table (16-bit rows of 272 bytes;
    pcenter's bias, 864 bytes at 4 phases)."""
    assert flk.gather_smem_bytes(216, 4) == 193_568
    assert flk.gather_smem_bytes(216, 1) == 135_360
    tiles4, tiles1 = 4 * 4 * 73 * 74, 4 * 4 * 42 * 42
    for tier, phases, want in (("float32", 4, 216 * 496 + 256 + tiles4),
                               ("float32", 1, 216 * 496 + 256 + tiles1),
                               ("bfloat16", 4, 216 * 272 + 256 + tiles4),
                               ("bfloat16", 1, 216 * 272 + 256 + tiles1),
                               ("pcenter", 4, 216 * 272 + 864 + 256 + tiles4),
                               ("int8", 4, 216 * 272 + 256 + tiles4)):
        assert flk.gather_smem_bytes(216, phases, tier, hashed=True) == want, (tier, phases)
    assert flk.gather_smem_bytes(256, 4, "pcenter", hashed=True) <= flk.MAX_SMEM_BYTES


@pytest.mark.parametrize("pixel_types,most", [(4, 294), (1, 411)])
def test_check_gather_smem_refuses_too_many_buckets(pixel_types, most):
    flk.check_gather_smem(most, pixel_types)
    for n in (most + 1, 1000):
        need = flk.gather_smem_bytes(n, pixel_types)
        with pytest.raises(ValueError, match=f"{n} buckets needs {need} bytes.*gives 232448"):
            flk.check_gather_smem(n, pixel_types)
    with pytest.raises(ValueError, match="no bucket"):
        flk.check_gather_smem(0, pixel_types)


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_apply_filters_on_cpu_takes_any_bank_size(pixel_types):
    """The size rule is the CUDA kernel's: on a CPU tensor apply_filters runs
    the plain version on a bank over it, out-of-range buckets giving 0."""
    rng = np.random.default_rng(5)
    n = 400
    f = torch.from_numpy(make_filters(rng, pixel_types, n))
    img = torch.from_numpy(smooth(20, 24, seed=5))
    b = torch.from_numpy(rng.integers(-5, n + 5, (20, 24)).astype(np.int32))
    out = flk.apply_filters(img, b, f, pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    bad = (b < 0) | (b >= n)
    assert bad.any() and (out[bad] == 0).all() and (out[~bad] != 0).all()


@pytest.mark.parametrize("h,w", [(1, 1), (16, 16), (22, 34), (37, 63), (38, 60), (70, 120),
                                 (70, 130), (101, 244), (75, 4700), (2160, 3840),
                                 (8736, 3840), (6552, 2880)])
def test_hash_tile_counts_match_a_plain_count(h, w):
    """The hash launch's tiles, counted over their coordinates: interior
    where the tile and the halo around it lie inside the plane."""
    rows, cols, halo = flk.HASH_TILE_ROWS, flk.HASH_TILE_COLS, flk.HASH_HALO
    interior = edge = 0
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            inside = (y0 - halo >= 0 and x0 - halo >= 0 and y0 + rows + halo <= h
                      and x0 + cols + halo <= w)
            interior += inside
            edge += not inside
    assert flk.hash_tile_counts(h, w) == (interior, edge)
    if h < rows + 2 * halo or w < cols + 2 * halo:
        assert interior == 0


def test_hash_tile_counts_of_the_serving_stacks():
    """The share of interior tiles on the 2x and 1.5x stacks of four 1080p
    frames and on one 4K plane."""
    assert flk.hash_tile_counts(8736, 3840) == (271 * 70, 273 * 72 - 271 * 70)
    assert flk.hash_tile_counts(6552, 2880) == (203 * 52, 205 * 54 - 203 * 52)
    assert flk.hash_tile_counts(2160, 3840) == (66 * 70, 68 * 72 - 66 * 70)


def test_hash_buckets_on_cpu_is_the_plain_hash_in_bytes():
    """On a CPU tensor hash_buckets runs the plain hash, as uint8, and
    launches nothing; it takes the CUDA kernel's bucket and edge limits on
    every device."""
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from torch_port_util import QCOH, QSTR

    img = torch.from_numpy(smooth(40, 70, seed=9))
    hkw = dict(k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
               nf=normalization_factor(8), qstr=QSTR, qcoh=QCOH)
    got = flk.hash_buckets(img, **hkw)
    assert got.dtype == torch.uint8
    assert torch.equal(got, flk.hash_buckets_reference(img, **hkw).to(torch.uint8))
    with pytest.raises(ValueError, match="at most 256 buckets"):
        flk.hash_buckets(img, **hkw, qangle=30)


# -- the gather launch A2's shared-memory reads, counted (gather_wavefronts) ---


def _phase_plane(h, w, pixel_types, value):
    """An [h, w] plane whose same-phase pixel (row i, column j) of every
    phase holds value(i, j)."""
    step = 2 if pixel_types == 4 else 1
    i = torch.arange(h)[:, None] // step
    j = torch.arange(w)[None, :] // step
    return value(i.expand(h, w), j.expand(h, w))


@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("label,value,waves", [
    ("one bucket", lambda i, j: torch.full_like(i, 37), 1.0),
    ("8 rows that agree mod 8", lambda i, j: 8 * (j % 8), 8.0),
    ("rows 0..7", lambda i, j: j % 8, 1.0),
    ("4 rows that agree mod 8, 2 lanes each", lambda i, j: 16 * (j % 4), 4.0),
])
def test_gather_wavefronts_parent_order(pixel_types, label, value, waves):
    """Under the parent's order (lane L on column L, bucket b's row at b) a
    quarter-warp's load takes as many wavefronts as the most distinct rows
    it reads that agree mod 8; planes of whole tiles, so no lane is idle."""
    step = 2 if pixel_types == 4 else 1
    b = _phase_plane(16 * step * 3, 32 * step * 2, pixel_types, value)
    got, reads = flk.gather_wavefronts(b, pixel_types, order="parent")
    assert got == waves, label
    assert reads == (11 + step) * 11 / 2


def _replay(buckets, pixel_types, slots):
    """The kernel's order, one warp at a time in plain Python: a warp takes 4
    same-phase rows of a 32 x 32 tile, sorts its 32 columns by the slot of
    pixel 1's bucket (ties by column), and lane L serves the L-th; each of
    its 4 loads a quarter-warp of 8 lanes at a time, whose wavefronts are
    the most distinct slots that agree mod 8. Pixels outside the plane read
    bucket 0."""
    step = 2 if pixel_types == 4 else 1
    h, w = buckets.shape
    loads = []
    for pr in range(step):
        for pc in range(step):
            sub = buckets[pr::step, pc::step].tolist()
            n_r, n_c = len(sub), len(sub[0]) if sub else 0
            for r0 in range(0, n_r, 32):
                for c0 in range(0, n_c, 32):
                    for wr in range(r0, r0 + 32, 4):
                        def slot(p, j):
                            r, c = wr + p, c0 + j
                            return int(slots[sub[r][c] if r < n_r and c < n_c else 0])
                        order = sorted(range(32), key=lambda j: (slot(1, j), j))
                        for p in range(4):
                            for q in range(4):
                                rows = {slot(p, j) for j in order[8 * q:8 * q + 8]}
                                loads.append(max(sum(1 for s in rows if s % 8 == g)
                                                 for g in range(8)))
    return sum(loads) / len(loads)


@pytest.mark.parametrize("pixel_types,h,w", [(4, 70, 130), (4, 64, 128), (1, 45, 77)])
def test_gather_wavefronts_kernel_order_is_a_replay(pixel_types, h, w):
    """Under the kernel's order the count equals a replay of the kernel's
    lane order and slot table, on random buckets and on a smooth plane's
    hash; ragged tiles included."""
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from torch_port_util import QCOH, QSTR

    gen = torch.Generator().manual_seed(h + w)
    rand = torch.randint(0, 216, (h, w), generator=gen)
    hashed = flk.hash_buckets_reference(
        torch.from_numpy(smooth(h, w, seed=3)),
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)), nf=normalization_factor(8),
        qstr=QSTR, qcoh=QCOH)
    slots = flk.bank_slots(24, 3, 3)
    step = 2 if pixel_types == 4 else 1
    for b in (rand, hashed):
        got, reads = flk.gather_wavefronts(b, pixel_types, slots)
        assert got == pytest.approx(_replay(b, pixel_types, slots.tolist()), abs=1e-12)
        assert reads == (11 + 3 * step) * 11 / 4
        ident, _ = flk.gather_wavefronts(b, pixel_types)  # apply_filters: slot = bucket
        assert ident == pytest.approx(_replay(b, pixel_types, list(range(216))), abs=1e-12)


def test_bank_slots_order_by_strength():
    """Bucket (angle * qstrength + strength) * qcoherence + coherence to slot
    (strength * qangle + angle) * qcoherence + coherence: a permutation, the
    buckets of one strength together, the identity for one strength."""
    slots = flk.bank_slots(24, 3, 3)
    assert sorted(slots.tolist()) == list(range(216))
    for a, s, c in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (5, 2, 1), (23, 2, 2)):
        assert int(slots[(a * 3 + s) * 3 + c]) == (s * 24 + a) * 3 + c
    assert torch.equal(flk.bank_slots(8, 1, 4), torch.arange(32))


def test_gather_wavefronts_sorting_cuts_the_rows_of_a_hashed_plane():
    """On a smooth plane's hash the kernel's order takes fewer wavefronts a
    load than the parent's, and on uniform random buckets no more."""
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from torch_port_util import QCOH, QSTR

    img = torch.from_numpy(smooth(256, 512, seed=4))
    b = flk.hash_buckets_reference(
        img, k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8), qstr=QSTR, qcoh=QCOH)
    slots = flk.bank_slots(24, 3, 3)
    parent, _ = flk.gather_wavefronts(b, 4, order="parent")
    kernel, _ = flk.gather_wavefronts(b, 4, slots)
    assert kernel < parent
    rand = torch.randint(0, 216, (256, 512), generator=torch.Generator().manual_seed(1))
    assert (flk.gather_wavefronts(rand, 4, slots)[0]
            <= flk.gather_wavefronts(rand, 4, order="parent")[0])
    with pytest.raises(ValueError, match="order"):
        flk.gather_wavefronts(b, 4, order="lanes")


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8"])
def test_gather_buckets_on_cpu_is_the_plain_filter_apply(tier):
    """On a CPU tensor gather_buckets runs apply_filters_reference on the
    uint8 plane, and refuses a bucket outside the bank or a plane of
    another dtype on every device."""
    from raisr_tpu_torch.ops.cuda import full_kernel as fk

    rng = np.random.default_rng(7)
    img = torch.from_numpy(smooth(30, 44, seed=6))
    f = torch.from_numpy(make_filters(rng, 4, 216))
    extra = {}
    if tier == "bfloat16":
        f = fk.round_bf16_error_diffused(f)
    elif tier == "int8":
        f, inv = fk.int8_bank(f)
        extra = dict(inv_scale=inv)
    b = torch.from_numpy(rng.integers(0, 216, (30, 44)).astype(np.uint8))
    got = flk.gather_buckets(img, b, f, tier=tier, **extra)
    want = flk.apply_filters_reference(img, b.to(torch.int32), f, **extra)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside the bank"):
        flk.gather_buckets(img, torch.full_like(b, 216), f)
    with pytest.raises(ValueError, match="uint8"):
        flk.gather_buckets(img, b.to(torch.int32), f)
