"""The port of the TPU probe kernel (tools/probe_s16.py `_kernel`, an
s8 x s8 -> s32 matmul) held against that kernel: its plain version (the int64
product, cast to int32) equals `_kernel` run through pl.pallas_call in
interpret mode, exactly, at small shapes (integer products and sums are
exact on both sides)."""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch
from jax.experimental import pallas as pl

from raisr_tpu_torch.ops.cuda import probe_s16 as ps

_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "probe_s16.py"


@pytest.fixture(scope="module")
def probe_kernel():
    """tools/probe_s16.py's `_kernel`. Importing the tool points JAX's
    compilation cache at the checkout; the test puts both settings back."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location("probe_s16_tool", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    assert (mod.M, mod.K, mod.N) == (ps.M, ps.K, ps.N)
    return mod._kernel


@pytest.mark.parametrize("m,k,n", [(24, 32, 40), (16, 144, 128)])
def test_plain_version_equals_pallas_probe_kernel(probe_kernel, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    a[0, :] = -128  # the extreme products: (-128)^2 summed k times
    b[:, 0] = -128
    ref = np.asarray(pl.pallas_call(
        probe_kernel, out_shape=jax.ShapeDtypeStruct((m, n), jnp.int32), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))
    out = ps.s8_matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32 and tuple(out.shape) == (m, n)
    assert np.array_equal(out.numpy(), ref)
    assert int(out[0, 0]) == 128 * 128 * k
    assert np.array_equal(ref.astype(np.int64), a.astype(np.int64) @ b.astype(np.int64))


def test_wrapper_on_cpu_runs_plain_version_and_checks():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-128, 128, (9, 12)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (12, 7)).astype(np.int8))
    before = ps.LAUNCHES
    assert torch.equal(ps.s8_matmul(a, b), ps.s8_matmul_reference(a, b))
    assert ps.LAUNCHES == before  # the kernel was not launched
    meta = torch.empty((9, 12), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ps.s8_matmul(meta, b.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        ps.s8_matmul(meta, b)
