"""The port's trainer (raisr_tpu_torch.train, device="cpu": the plain
accumulation of ops/cuda/normal_eq.py and the plain filter apply and
epilogue) against raisr_tpu.train on the same numpy pairs.

Pairs are tiny (HR 32x40 at 2x, 27x33 at 1.5x): smooth noise with fine
noise on top at the HR size, LR by the CLI's degradations (box 2x, exact
2/3 area). JAX's results are computed once per configuration in
module-scoped fixtures; the file takes about 30 s on one worker.

Tolerances:
  - Q and V: within 1e-5 of the largest entry. The two packages sum in
    other orders in float32.
  - Banks: rtol 2e-3, atol 2e-4, the JAX package's own bound between two
    summation orders (tests/test_train.py:96); CT-refined banks atol 5e-4
    (tests/test_train.py:116). The two packages solve in float32 with
    different LAPACKs, whose results differ by about cond * eps, and the
    relative regularization bounds cond by taps / lam: the bank tests train
    at lam 0.05 (the JAX package's symmetry test's), where the two solves of
    the same Q and V differ by ~3e-5 (~2e-4 at the default 0.01).
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.config import RaisrConfig as JaxRaisrConfig
from raisr_tpu.model.loader import load_model as jax_load_model
from raisr_tpu.train import trainer as jt
from raisr_tpu.ops.resize import cheap_upscale as jax_cheap_upscale
from raisr_tpu_torch import RaisrConfig, RaisrError, load_model
from raisr_tpu_torch.ops.cuda import normal_eq as ne
from raisr_tpu_torch.ops.resize import cheap_upscale
from raisr_tpu_torch.train import save_filter_folder
from raisr_tpu_torch.train import trainer as pt
from torch_port_util import hash_agreement

LAM = 0.05
BANK_TOL = dict(rtol=2e-3, atol=2e-4)
CT_TOL = dict(rtol=2e-3, atol=5e-4)
LR_SHAPE = {2.0: (16, 20), 1.5: (18, 22)}


def make_pairs(n, ratio=2.0, bits=8, seed=0):
    """n (lr, hr) uint16 pairs: HR of smooth noise (a 3-tap box twice) plus
    fine noise, full range; LR by trainer.degrade."""
    rng = np.random.default_rng(seed)
    lh, lw = LR_SHAPE[ratio]
    hh, hw = int(lh * ratio), int(lw * ratio)
    top = (1 << bits) - 1
    out = []
    for _ in range(n):
        img = rng.normal(size=(hh, hw))
        for ax in (0, 1):
            img = np.apply_along_axis(lambda r: np.convolve(r, np.ones(3) / 3, "same"), ax, img)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        hr = np.clip(np.floor(img * top) + rng.integers(-2, 3, img.shape), 0, top)
        out.append(pt.degrade(hr, ratio, bits))
    return out


def _cfgs(**kw):
    return jt.TrainConfig(**kw), pt.TrainConfig(**kw)


def _planes(lr, hr, bits, mode="bilinear"):
    """(JAX cheap, port cheap, port hr) float32 planes of one pair."""
    cheap_j = jax_cheap_upscale(jnp.asarray(lr, jnp.float32), *hr.shape, bits, mode=mode)
    cheap_t = cheap_upscale(torch.tensor(lr.astype(np.float32)), *hr.shape, bits, mode=mode)
    np.testing.assert_array_equal(cheap_t.numpy(), np.asarray(cheap_j))
    return cheap_j, cheap_t, torch.tensor(hr.astype(np.float32))


def _provisional(nf, seed=3):
    rng = np.random.default_rng(seed)
    f = np.zeros((nf, 128), np.float32)
    f[:, :121] = rng.normal(size=(nf, 121)).astype(np.float32) * 0.01
    f[:, 60] += 1.0
    return f


# -- the accumulators of one pair ---------------------------------------------


@pytest.mark.parametrize("kind,ratio,bits", [
    ("plain", 2.0, 8), ("plain", 1.5, 10), ("plain", 2.0, 16), ("ct1", 2.0, 8), ("ct2", 2.0, 8),
    ("ct2", 1.5, 8)])
def test_accumulators_match_jax(kind, ratio, bits):
    jcfg, tcfg = _cfgs(ratio=ratio, bits=bits, chunk=256)
    lr, hr = make_pairs(1, ratio, bits, seed=11)[0]
    cheap_j, cheap_t, hr_t = _planes(lr, hr, bits)
    q0, v0 = jt.init_accumulators(jcfg)
    q, v = pt.init_accumulators(tcfg)
    if kind == "plain":
        qj, vj = jt.accumulate_pair(q0, v0, cheap_j, jnp.asarray(hr, jnp.float32), jcfg)
        pt.accumulate_pair(q, v, cheap_t, hr_t, tcfg)
    else:
        blending = int(kind[-1])
        f = _provisional(jcfg.num_filters)
        qj, vj = jt.accumulate_pair_ct(q0, v0, cheap_j, jnp.asarray(hr, jnp.float32),
                                       jnp.asarray(f), jcfg, blending)
        pt.accumulate_pair_ct(q, v, cheap_t, hr_t, torch.tensor(f), tcfg, blending)
    qj, vj = np.asarray(qj), np.asarray(vj)
    assert np.abs(qj).max() > 0
    np.testing.assert_allclose(q.numpy(), qj, rtol=0, atol=1e-5 * np.abs(qj).max())
    np.testing.assert_allclose(v.numpy(), vj, rtol=0, atol=1e-5 * np.abs(vj).max())
    assert torch.equal(q, q.transpose(1, 2))  # exactly symmetric, as JAX's


def test_plain_accumulation_chunk_independent():
    """normal_eq_reference with 7-row and 4096-row chunks: the same Q and V
    within 1e-6 of the largest entry, and each exactly symmetric."""
    lr, hr = make_pairs(1, 2.0, 10, seed=4)[0]
    _, cheap, hr_t = _planes(lr, hr, 10)
    tcfg = pt.TrainConfig(bits=10)
    _, idx = pt._filter_index(cheap, tcfg)
    s = torch.rand(cheap.shape, generator=torch.Generator().manual_seed(0))
    out = []
    for chunk in (7, 4096):
        q, v = pt.init_accumulators(tcfg)
        ne.normal_eq_reference(q, v, cheap, hr_t, idx, s, chunk=chunk)
        assert torch.equal(q, q.transpose(1, 2))
        out.append((q, v))
    (q7, v7), (q4k, v4k) = out
    assert float((q7 - q4k).abs().max()) <= 1e-6 * float(q4k.abs().max())
    assert float((v7 - v4k).abs().max()) <= 1e-6 * float(v4k.abs().max())


def test_plain_accumulation_matches_float64_sums():
    """The plain version against the sums written out in float64 over the
    pixels one by one, with a weight plane."""
    lr, hr = make_pairs(1, 1.5, 8, seed=5)[0]
    _, cheap, hr_t = _planes(lr, hr, 8)
    tcfg = pt.TrainConfig(ratio=1.5)
    _, idx = pt._filter_index(cheap, tcfg)
    s = torch.rand(cheap.shape, generator=torch.Generator().manual_seed(1))
    q, v = pt.init_accumulators(tcfg)
    ne.normal_eq_reference(q, v, cheap, hr_t, idx, s, chunk=64)
    c, y, sw, ix = cheap.numpy(), hr_t.numpy(), s.numpy(), idx.numpy()
    q_exp = np.zeros((tcfg.num_filters, 121, 121))
    v_exp = np.zeros((tcfg.num_filters, 121))
    for r in range(ix.shape[0]):
        for col in range(ix.shape[1]):
            p = (c[r + 1: r + 12, col + 1: col + 12].reshape(-1) * sw[r + 6, col + 6]).astype(
                np.float64)
            q_exp[ix[r, col]] += np.outer(p, p)
            v_exp[ix[r, col]] += y[r + 6, col + 6] * p
    np.testing.assert_allclose(q.numpy(), q_exp, rtol=0, atol=1e-5 * np.abs(q_exp).max())
    np.testing.assert_allclose(v.numpy(), v_exp, rtol=0, atol=1e-5 * np.abs(v_exp).max())


# -- banks ----------------------------------------------------------------


BANK_CASES = [  # (ratio, bits, augment_symmetry, resize_mode)
    (2.0, 8, False, "bilinear"),
    (2.0, 10, True, "cubic"),
    (1.5, 8, True, "bilinear"),
    (1.5, 10, False, "lanczos"),
]


@pytest.fixture(scope="module", params=BANK_CASES, ids=lambda c: "-".join(map(str, c)))
def trained(request):
    ratio, bits, augment, mode = request.param
    kw = dict(ratio=ratio, bits=bits, augment_symmetry=augment, resize_mode=mode, lam=LAM,
              chunk=512)
    jcfg, tcfg = _cfgs(**kw)
    pairs = make_pairs(1 if augment else 2, ratio, bits, seed=int(2 * ratio) + bits)
    rows, flipped = hash_agreement(pairs, jcfg, tcfg)
    return dict(pairs=pairs, tcfg=tcfg, rows=rows, flipped=flipped,
                jax=jt.train_filterbank(pairs, jcfg),
                port=pt.train_filterbank(pairs, tcfg, device="cpu"))


def test_bank_matches_jax(trained):
    """Every filter whose pixels hashed alike in both packages within the
    bank tolerance; pixels that flipped bucket stay under the cross-backend
    bar (under 2%), and their filters are left out (one pixel more or less
    moves a filter of a few pixels by far more than any tolerance)."""
    port, jax_bank, rows = trained["port"], trained["jax"], trained["rows"]
    assert port.filters.shape == jax_bank.filters.shape == (trained["tcfg"].num_filters, 128)
    assert port.pixel_types == jax_bank.pixel_types and port.taps == 121
    np.testing.assert_array_equal(port.qstr, jax_bank.qstr)
    assert trained["flipped"] < 0.02, trained["flipped"]
    np.testing.assert_allclose(port.filters[rows], jax_bank.filters[rows], **BANK_TOL)


def test_empty_buckets_are_the_identity_exactly(trained):
    tcfg = trained["tcfg"]
    hit = set()
    for lr, hr in trained["pairs"]:
        for lr_t, hr_t in pt._dihedral_transforms(lr, hr, tcfg.augment_symmetry):
            cheap = pt._cheap(torch.tensor(lr_t.astype(np.float32)),
                              torch.tensor(hr_t.astype(np.float32)), tcfg)
            hit.update(pt._filter_index(cheap, tcfg)[1].unique().tolist())
    empty = np.setdiff1d(np.arange(tcfg.num_filters), sorted(hit))
    assert 0 < len(empty) < tcfg.num_filters
    identity = np.zeros(128, np.float32)
    identity[60] = 1.0
    assert (trained["port"].filters[empty] == identity).all()
    assert (trained["jax"].filters[empty] == identity).all()


def test_exported_folder_loads_in_both_packages(trained, tmp_path):
    bank, tcfg = trained["port"], trained["tcfg"]
    folder = str(tmp_path / "bank")
    save_filter_folder(folder, [bank, bank], bits=tcfg.bits)
    kw = dict(filterfolder=folder, ratio=tcfg.ratio, bits=tcfg.bits, passes=2)
    for model in (load_model(folder, RaisrConfig(**kw)),
                  jax_load_model(folder, JaxRaisrConfig(**kw))):
        assert len(model.banks) == 2 and model.qangle == 24
        np.testing.assert_array_equal(np.asarray(model.banks[1].filters), bank.filters)
        np.testing.assert_allclose(np.asarray(model.banks[0].qcoh), bank.qcoh, rtol=1e-5)


@pytest.fixture(scope="module")
def seed_bank():
    """A plain 2x 8-bit bank and its pairs, the seed of the CT and pass-2
    comparisons (JAX's, so both packages start from the same bank)."""
    jcfg, tcfg = _cfgs(lam=LAM, chunk=512)
    pairs = make_pairs(2, 2.0, 8, seed=21)
    return pairs, jcfg, tcfg, jt.train_filterbank(pairs, jcfg)


@pytest.mark.parametrize("blending", [1, 2])
def test_ct_refined_bank_matches_jax(seed_bank, blending):
    pairs, jcfg, tcfg, _ = seed_bank
    jax_bank = jt.train_filterbank_ct(lambda: iter(pairs), jcfg, blending=blending)
    port = pt.train_filterbank_ct(lambda: iter(pairs), tcfg, blending=blending, device="cpu")
    np.testing.assert_allclose(port.filters, jax_bank.filters, **CT_TOL)


def test_pass2_bank_matches_jax(seed_bank):
    pairs, jcfg, tcfg, bank1 = seed_bank
    jax_bank = jt.train_filterbank_pass2(pairs, jcfg, bank1)
    port = pt.train_filterbank_pass2(pairs, tcfg, bank1, device="cpu")
    np.testing.assert_allclose(port.filters, jax_bank.filters, **BANK_TOL)


def test_pass2_input_is_the_taps_pass(seed_bank):
    """The pass-1 output the pass-2 bank trains on is the port's taps pass
    (engine, backend reference) of the pass-1 bank, bit for bit."""
    from raisr_tpu_torch.model.loader import RaisrModel
    from raisr_tpu_torch.ops.pipeline import pass_banks, pass_statics, process_plane_y

    pairs, _, tcfg, bank1 = seed_bank
    lr, hr = pairs[0]
    model = RaisrModel(24, 3, 3, 11, (bank1,))
    statics = pass_statics(RaisrConfig(passes=1), model, "taps")
    lr_t = torch.tensor(lr.astype(np.float32))
    want = process_plane_y(lr_t, pass_banks(statics, [torch.tensor(bank1.filters)]), statics,
                           1, 1, *hr.shape)
    got = pt._taps_pass(pt._cheap(lr_t, torch.tensor(hr.astype(np.float32)), tcfg),
                        torch.tensor(bank1.filters), statics)
    assert torch.equal(got, want)


# -- the card is the default --------------------------------------------------


def test_entry_points_default_to_the_card():
    """device defaults to cuda: without a card every entry point raises the
    CUDA RaisrError before any work; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pairs = make_pairs(1)
    cfg = pt.TrainConfig()
    bank = pt.train_filterbank(pairs, cfg, device="cpu")
    calls = [lambda: pt.train_filterbank(pairs, cfg),
             lambda: pt.train_filterbank_ct(lambda: iter(pairs), cfg),
             lambda: pt.train_filterbank_pass2(pairs, cfg, bank)]
    for call in calls:
        with pytest.raises(RaisrError, match="CUDA is not available"):
            call()


def test_degradations():
    """box_down2 and area_down_2of3 are exact area means; degrade crops to
    the ratio's multiple and rounds half up."""
    x = np.arange(36, dtype=np.float64).reshape(6, 6)
    np.testing.assert_array_equal(pt.box_down2(x), x.reshape(3, 2, 3, 2).mean(axis=(1, 3)))
    down = pt.area_down_2of3(x)
    assert down.shape == (4, 4)
    assert down[0, 0] == pytest.approx((x[0, 0] + 0.5 * x[0, 1] + 0.5 * x[1, 0]
                                        + 0.25 * x[1, 1]) / 2.25)
    lr, hr = pt.degrade(np.full((7, 8), 3.0), 1.5, 8)
    assert hr.shape == (6, 6) and lr.shape == (4, 4) and (lr == 3).all()
    lr, hr = pt.degrade(np.array([[0, 1], [0, 1]], np.float64), 2.0, 8)
    assert lr.tolist() == [[1]]  # 0.5 rounds up
