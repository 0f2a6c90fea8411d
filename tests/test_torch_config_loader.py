"""raisr_tpu_torch config and loader held against raisr_tpu: the same
validation errors, the same arrays loaded bit for bit, the same folders."""

import os

import numpy as np
import pytest
import torch

import raisr_tpu.config as jcfg
import raisr_tpu.model.loader as jloader
import raisr_tpu.train.export as jexport
import raisr_tpu_torch.config as tcfg
import raisr_tpu_torch.model.loader as tloader
import raisr_tpu_torch.train.export as texport
from torch_port_util import make_jax_model


BAD_CONFIGS = [
    dict(passes=3),
    dict(bits=12),
    dict(blending=3),
    dict(mode=3),
    dict(ratio=5.0),
    dict(ratio=1.0),
    dict(dtype="fp8"),
    dict(dtype="int8", bits=10),
    dict(dtype="int8", ratio=1.5),
    dict(resize_mode="nearest"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: repr(kw))
def test_config_validation_errors_match(kw):
    with pytest.raises(jcfg.RaisrError) as je:
        jcfg.RaisrConfig(**kw)
    with pytest.raises(tcfg.RaisrError) as te:
        tcfg.RaisrConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(passes=2, mode=2, bits=10, range=1),
    dict(bits=16, ratio=1.5, evenoutput=True, dtype="auto"),
])
def test_config_derived_values_match(kw):
    j, t = jcfg.RaisrConfig(**kw), tcfg.RaisrConfig(**kw)
    for name in ("min_val", "max_val", "use_pixel_type", "two_pass_mode", "dtype"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.output_size(541, 961) == j.output_size(541, 961)


def _jax_folder(tmp_path, passes, bits):
    folder = str(tmp_path / f"bank_{passes}_{bits}")
    m = make_jax_model(passes=passes, seed=passes * 10 + bits)
    jexport.save_filter_folder(folder, list(m.banks), bits=bits)
    return folder


@pytest.mark.parametrize("passes,bits", [(1, 8), (2, 8), (2, 10)])
def test_load_model_bit_identical(tmp_path, passes, bits):
    folder = _jax_folder(tmp_path, passes, bits)
    jm = jloader.load_model(folder, jcfg.RaisrConfig(passes=passes, bits=bits))
    tm = tloader.load_model(folder, tcfg.RaisrConfig(passes=passes, bits=bits))
    for name in ("qangle", "qstrength", "qcoherence", "patch_size"):
        assert getattr(tm, name) == getattr(jm, name)
    assert len(tm.banks) == len(jm.banks) == passes
    for jb, tb in zip(jm.banks, tm.banks):
        for name in ("filters", "qstr", "qcoh"):
            a, b = getattr(jb, name), getattr(tb, name)
            assert b.dtype == a.dtype == np.float32
            assert np.array_equal(a, b), name
        assert (tb.pixel_types, tb.taps, tb.source_dtype) == (
            jb.pixel_types, jb.taps, jb.source_dtype)


@pytest.mark.parametrize("corrupt", ["no_config", "bad_token", "patch_9",
                                     "short_filterbin", "bad_qfactor"])
def test_corrupt_folder_errors_match(tmp_path, corrupt):
    folder = _jax_folder(tmp_path, 1, 8)
    if corrupt == "no_config":
        os.remove(os.path.join(folder, "config"))
    elif corrupt == "bad_token":
        with open(os.path.join(folder, "config"), "w") as f:
            f.write("24 x 3 11")
    elif corrupt == "patch_9":
        with open(os.path.join(folder, "config"), "w") as f:
            f.write("24 3 3 9")
    elif corrupt == "short_filterbin":
        path = os.path.join(folder, "filterbin_2_8")
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:-4])
    else:
        with open(os.path.join(folder, "Qfactor_strbin_2_8"), "w") as f:
            f.write("0.1/2\n0.3\n")
    with pytest.raises(jcfg.RaisrError) as je:
        jloader.load_model(folder, jcfg.RaisrConfig())
    with pytest.raises(tcfg.RaisrError) as te:
        tloader.load_model(folder, tcfg.RaisrConfig())
    assert str(te.value) == str(je.value)


def test_from_jax_model_round_trips(tmp_path):
    jm = make_jax_model(passes=2, seed=3)
    tm = tloader.from_jax_model(jm)
    assert isinstance(tm, tloader.RaisrModel)
    assert (tm.qangle, tm.qstrength, tm.qcoherence, tm.patch_size) == (24, 3, 3, 11)
    for jb, tb in zip(jm.banks, tm.banks):
        assert np.array_equal(jb.filters, tb.filters)
        assert np.array_equal(jb.qstr, tb.qstr)
        assert np.array_equal(jb.qcoh, tb.qcoh)
        assert tb.filters is not jb.filters  # a copy, not a view
    # the port's exporter writes a folder the JAX loader reads back exactly
    folder = str(tmp_path / "port_bank")
    texport.save_filter_folder(folder, list(tm.banks), bits=8)
    back = jloader.load_model(folder, jcfg.RaisrConfig(passes=2))
    for jb, bb in zip(jm.banks, back.banks):
        assert np.array_equal(jb.filters, bb.filters)


def test_bank_tensors_cpu():
    tm = tloader.from_jax_model(make_jax_model(passes=2, seed=4))
    filters, qstr, qcoh = tloader.bank_tensors(tm, "cpu")
    assert len(filters) == len(qstr) == len(qcoh) == 2
    for f, s, c, b in zip(filters, qstr, qcoh, tm.banks):
        assert f.shape == (864, 128) and f.dtype == torch.float32
        assert f.is_contiguous() and f.device.type == "cpu"
        assert np.array_equal(f.numpy(), b.filters)
        assert np.array_equal(s.numpy(), b.qstr)
        assert np.array_equal(c.numpy(), b.qcoh)
