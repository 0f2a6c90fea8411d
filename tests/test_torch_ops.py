"""raisr_tpu_torch ops held against raisr_tpu ops on the same inputs.

Stages whose values are exact in float32 whatever the order of operations
(the 2x cheap upscale, gradients, census counts and weights, pixel phases,
zone bounds) must be bit-identical. Sums of rounded products get a stated
tolerance: the two libraries may add or fuse them in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.config import RaisrConfig as JConfig
from raisr_tpu.model.gaussian import gaussian_kernel_1d, gaussian_weights, normalization_factor
from raisr_tpu.ops import census as jcensus, hashing as jhash
from raisr_tpu.ops.filter_apply import apply_filters_taps as j_taps
from raisr_tpu.ops.pipeline import (
    _finish_pass as j_finish,
    pass_statics as j_statics,
    processed_col_end as j_col_end,
)
from raisr_tpu.ops.resize import cheap_upscale as j_cheap
from raisr_tpu_torch.config import RaisrConfig, RaisrError
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops import census as tcensus, hashing as thash
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps as t_taps
from raisr_tpu_torch.ops.pipeline import (
    _finish_pass as t_finish,
    pass_banks as t_banks,
    pass_statics as t_statics,
    processed_col_end as t_col_end,
)
from raisr_tpu_torch.ops.resize import cheap_upscale as t_cheap
from torch_port_util import QCOH, QSTR, jax_tier, make_jax_model, smooth


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _n(a) -> np.ndarray:
    return np.asarray(a)


@pytest.mark.parametrize("h,w,bits", [(20, 30, 8), (17, 23, 8), (9, 40, 10)])
def test_cheap_upscale_2x_bit_identical(h, w, bits):
    img = smooth(h, w, bits, seed=h + w)
    ref = _n(j_cheap(jnp.asarray(img), 2 * h, 2 * w, bits))
    out = t_cheap(_t(img), 2 * h, 2 * w, bits)
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), ref)
    # a batch of planes is upscaled plane by plane
    batch = np.stack([img, img[::-1].copy()])
    out_b = t_cheap(_t(batch), 2 * h, 2 * w, bits).numpy()
    assert np.array_equal(out_b[0], ref)
    assert np.array_equal(out_b[1], _n(j_cheap(jnp.asarray(batch[1]), 2 * h, 2 * w, bits)))


def test_cheap_upscale_unported_modes_raise():
    img = _t(smooth(8, 8))
    # every bilinear ratio is ported (tests/test_torch_resize.py) ...
    assert tuple(t_cheap(img, 12, 12, 8).shape) == (12, 12)
    # ... and so are the cubic and lanczos resamplers
    # (tests/test_torch_resize_modes.py); a mode that is none of the three
    # is what raises
    for mode in ("cubic", "lanczos"):
        assert tuple(t_cheap(img, 16, 16, 8, mode=mode).shape) == (16, 16)
    with pytest.raises(RaisrError, match="bicubic"):
        t_cheap(img, 16, 16, 8, mode="bicubic")


def test_gradients_bit_identical():
    img = smooth(33, 47, seed=1)
    jgx, jgy = jhash.gradients(jnp.asarray(img))
    tgx, tgy = thash.gradients(_t(img))
    assert np.array_equal(tgx.numpy(), _n(jgx))
    assert np.array_equal(tgy.numpy(), _n(jgy))


def test_census_count_and_cobc_weight_bit_identical():
    rng = np.random.default_rng(2)
    lr = smooth(30, 41, seed=2)
    hr = lr + rng.integers(-3, 4, lr.shape).astype(np.float32)
    assert np.array_equal(
        tcensus.census_count(_t(lr)).numpy(), _n(jcensus.census_count(jnp.asarray(lr)))
    )
    assert np.array_equal(
        tcensus.cobc_weight(_t(lr), _t(hr)).numpy(),
        _n(jcensus.cobc_weight(jnp.asarray(lr), jnp.asarray(hr))),
    )


@pytest.mark.parametrize("mode", ["randomness", "cobc"])
def test_census_blends_match(mode):
    rng = np.random.default_rng(3)
    lr = smooth(30, 41, seed=3)
    hr = lr + rng.normal(0, 4, lr.shape).astype(np.float32)
    fj = getattr(jcensus, "blend_randomness" if mode == "randomness"
                 else "blend_count_of_bits_changed")
    ft = getattr(tcensus, "blend_randomness" if mode == "randomness"
                 else "blend_count_of_bits_changed")
    ref = _n(fj(jnp.asarray(lr), jnp.asarray(hr)))
    out = ft(_t(lr), _t(hr)).numpy()
    # two products and a sum of 8-bit-scale values: 1e-4 is < 2 ulp at 255
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w", [(12, 18), (13, 17)])
def test_pixel_types_bit_identical(h, w):
    for use in (True, False):
        ref = _n(jhash.pixel_types(h, w, 2, 5, use))
        out = thash.pixel_types(h, w, 2, 5, use)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), ref)


def test_processed_col_end_matches():
    for w in range(1, 80):
        for exact in (True, False):
            assert t_col_end(w, 6, exact) == j_col_end(w, 6, exact)
    assert t_col_end(3840, 6, True) == 3830


def _tensor_inputs(seed):
    img = smooth(40, 52, seed=seed)
    gx, gy = jhash.gradients(jnp.asarray(img))
    return img, gx, gy


def test_structure_tensor_separable_matches():
    _, gx, gy = _tensor_inputs(4)
    k1d, nf = gaussian_kernel_1d(11), normalization_factor(8)
    ref = jhash.structure_tensor_separable(gx, gy, k1d, nf)
    out = thash.structure_tensor_separable(_t(gx), _t(gy), k1d, nf)
    for r, o in zip(ref, out):
        r = _n(r)
        # the same shift-multiply-adds in the same order; XLA may still fuse
        # a product into an add, so allow 4 ulp of the map's largest value
        tol = 4 * np.spacing(np.float32(np.abs(r).max()))
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=tol)


def test_structure_tensor_literal_matches():
    _, gx, gy = _tensor_inputs(5)
    wts = gaussian_weights(11, 8)
    ref = jhash.structure_tensor(gx, gy, jnp.asarray(wts))
    out = thash.structure_tensor(_t(gx), _t(gy), wts)
    for r, o in zip(ref, out):
        r = _n(r)
        # XLA's convolution sums the 121 window products in its own order:
        # allow 1e-5 of the map's largest value (about 80 ulp)
        tol = 1e-5 * float(np.abs(r).max())
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=tol)


def test_hash_buckets_match():
    _, gx, gy = _tensor_inputs(6)
    k1d, nf = gaussian_kernel_1d(11), normalization_factor(8)
    a, b, d = jhash.structure_tensor_separable(gx, gy, k1d, nf)
    qs, qc = jnp.asarray(QSTR, jnp.float32), jnp.asarray(QCOH, jnp.float32)
    ref = _n(jhash.hash_buckets(a, b, d, qs, qc, 24, 3, 3))
    out = thash.hash_buckets(_t(a), _t(b), _t(d), _t(qs), _t(qc), 24, 3, 3)
    assert out.dtype == torch.int32
    # identical formula on identical inputs: only an exact tie may flip
    assert (out.numpy() == ref).mean() >= 0.999
    # edges given as python floats bin the same way
    out_f = thash.hash_buckets(_t(a), _t(b), _t(d), QSTR, QCOH, 24, 3, 3)
    assert torch.equal(out_f, out)
    assert 0 <= int(out.min()) and int(out.max()) < 216


def test_sqrt_rn_is_correctly_rounded():
    """The hash's roots on the CPU are the correctly rounded ones (numpy's
    and the float64 root rounded to float32 agree), as JAX's and the card's
    are; PyTorch's own CPU sqrt is MKL's and is not."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0x00800000, 0x7F800000, 1 << 16, dtype=np.int64).astype(np.uint32)
    x = bits.view(np.float32)
    got = thash.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
    strided = torch.from_numpy(x).reshape(256, 256)[:, ::2]
    np.testing.assert_array_equal(thash.sqrt_rn(strided).numpy(), got.reshape(256, 256)[:, ::2])


def test_atan2_approx_matches():
    rng = np.random.default_rng(7)
    y = rng.normal(size=500).astype(np.float32)
    x = rng.normal(size=500).astype(np.float32)
    ref = _n(jhash.atan2_approx(jnp.asarray(y), jnp.asarray(x)))
    out = thash.atan2_approx(_t(y), _t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=4 * np.spacing(np.float32(np.pi)))


def test_apply_filters_taps_matches():
    img = smooth(36, 44, seed=8)
    filters = make_jax_model(passes=1, seed=8).banks[0].filters
    idx = np.random.default_rng(8).integers(0, 864, img.shape).astype(np.int32)
    ref = _n(j_taps(jnp.asarray(img), jnp.asarray(idx), jnp.asarray(filters), 11))
    out = t_taps(_t(img), _t(idx), _t(filters), 11).numpy()
    # 121 products of 8-bit values, summed in tap order 0..120 by the port;
    # XLA may contract into FMAs: allow 1e-3 at an output scale of ~255
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("blending", [1, 2])
def test_finish_pass_bit_identical(blending):
    rng = np.random.default_rng(9 + blending)
    cheap = np.round(rng.uniform(0, 255, (30, 40))).astype(np.float32)
    raw = cheap + rng.normal(0, 6, cheap.shape).astype(np.float32)
    jm = make_jax_model(passes=1)
    js = j_statics(JConfig(blending=blending), jm, "taps")
    ref = _n(j_finish(jnp.asarray(cheap), jnp.asarray(raw), js))
    out = t_finish(
        _t(cheap), _t(raw), min_val=16, max_val=235, blending=blending,
        loop_margin=6, col_end=t_col_end(40, 6, True),
    ).numpy()
    assert np.array_equal(out, ref)


def test_pass_statics_tiers():
    """The fused backend serves every tier of raisr_tpu's pass_statics:
    float32 at every depth (mxu_passes 2 and 3), bf16 at 8 bits
    (mxu_passes=1), pcenter for bfloat16/auto at 10 bits, p_split (the bf16
    bank) for bfloat16 at 16 bits and bfloat16_exact at 10/16, and int8. The
    taps backend ignores the tier, as in raisr_tpu."""
    jm = make_jax_model(passes=1)
    tm = from_jax_model(jm)
    s = t_statics(RaisrConfig(), tm, "pallas")
    js = j_statics(JConfig(), jm, "pallas")
    assert s.bank_edges == js.bank_edges
    assert (s.min_val, s.max_val, s.blending, s.loop_margin) == (
        js.min_val, js.max_val, js.blending, js.loop_margin)
    assert s.tier == "float32"
    tiers = {}
    cases = [(d, b) for d in ("float32", "bfloat16", "bfloat16_exact", "auto")
             for b in (8, 10, 16)] + [("int8", 8)]
    for dtype, bits in cases:
        s = t_statics(RaisrConfig(dtype=dtype, bits=bits), tm, "pallas")
        js = j_statics(JConfig(dtype=dtype, bits=bits), jm, "pallas")
        assert s.tier == jax_tier(js), (dtype, bits, js)
        tiers[dtype, bits] = s.tier
    assert tiers == {
        ("float32", 8): "float32", ("float32", 10): "float32", ("float32", 16): "float32",
        ("bfloat16", 8): "bfloat16", ("bfloat16", 10): "pcenter", ("bfloat16", 16): "bfloat16",
        ("bfloat16_exact", 8): "bfloat16", ("bfloat16_exact", 10): "bfloat16",
        ("bfloat16_exact", 16): "bfloat16",
        ("auto", 8): "bfloat16", ("auto", 10): "pcenter", ("auto", 16): "bfloat16",
        ("int8", 8): "int8",
    }
    for dtype, bits in (("bfloat16", 8), ("bfloat16", 10), ("bfloat16_exact", 16), ("int8", 8)):
        s = t_statics(RaisrConfig(dtype=dtype, bits=bits), tm, "taps")
        assert s.backend == "taps" and s.tier == "float32"


def test_pass_statics_single_phase():
    """A 1.5x config with a single-phase bank: the fused backend takes it at
    the float32 tier, with raisr_tpu's statics, and at the bf16 tier, which
    is p_split at 10/16 bits (raisr_tpu's single-phase kernel has no
    pcenter)."""
    jm = make_jax_model(passes=1, pixel_types=1)
    tm = from_jax_model(jm)
    s = t_statics(RaisrConfig(ratio=1.5), tm, "pallas")
    js = j_statics(JConfig(ratio=1.5), jm, "pallas")
    assert (s.pixel_types, s.use_pixel_type, s.ratio_int) == (
        js.pixel_types, js.use_pixel_type, js.ratio_int) == (1, False, 1)
    assert s.bank_edges == js.bank_edges
    for dtype in ("bfloat16", "bfloat16_exact"):
        assert t_statics(RaisrConfig(ratio=1.5, dtype=dtype), tm, "pallas").tier == "bfloat16"
        for bits in (10, 16):
            s = t_statics(RaisrConfig(ratio=1.5, dtype=dtype, bits=bits), tm, "pallas")
            js = j_statics(JConfig(ratio=1.5, dtype=dtype, bits=bits), jm, "pallas")
            assert s.tier == "bfloat16" and js.p_split and not js.pcenter
    # a 2x bank (4 pixel types) at ratio 1.5 has no fused form: raisr_tpu's
    # unfused filter kernel asserts ratio 2
    with pytest.raises(RaisrError, match="asserts pixel_types == 4 and ratio == 2"):
        t_statics(RaisrConfig(ratio=1.5), from_jax_model(make_jax_model(1)), "pallas")
    # at 2.5x it is served with phase 0 everywhere (ROADMAP C9): the fused
    # backend reads the bank's phase-0 rows through the single-phase pass
    m4 = from_jax_model(make_jax_model(1))
    s25 = t_statics(RaisrConfig(ratio=2.5), m4, "pallas")
    assert (s25.pixel_types, s25.use_pixel_type, s25.ratio_int) == (4, False, 2)
    f = torch.from_numpy(m4.banks[0].filters)
    (bank,) = t_banks(s25, (f,))
    assert bank.filters.shape == (216, 128) and bank.filters.is_contiguous()
    assert torch.equal(bank.filters, f[0::4])
    (bank16,) = t_banks(t_statics(RaisrConfig(ratio=2.5, dtype="auto"), m4, "pallas"), (f,))
    assert bank16.filters.dtype == torch.bfloat16 and bank16.filters.shape == (216, 128)
    # at 10 bits that route runs p_split; raisr_tpu asks for pcenter there
    # but runs its unfused kernel without it (ROADMAP C10)
    s25 = t_statics(RaisrConfig(ratio=2.5, dtype="bfloat16", bits=10), m4, "pallas")
    js25 = j_statics(JConfig(ratio=2.5, dtype="bfloat16", bits=10), make_jax_model(1), "pallas")
    assert s25.tier == "bfloat16" and js25.pcenter == 512.0 and not js25.use_pixel_type
