"""Port helpers against their JAX counterparts in float64: the real/complex
packings, the row -> timeslot map, the dtype identities, the residual
write-back layout, the host-side uv cut, the per-chunk weighted cost and
the executed-trip totals (exact, or rtol 1e-12 where a sum is taken in
another order)."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sagecal_tpu import dtypes as dtp
from sagecal_tpu import utils
from sagecal_tpu.io import dataset as ds
from sagecal_tpu.rime import predict as rp
from sagecal_tpu.rime import residual as rr
from sagecal_tpu.solvers import lm as lm_mod
from sagecal_tpu.solvers import normal_eq as ne
from sagecal_tpu_torch import dtypes as tdtp
from sagecal_tpu_torch import utils as tutils
from sagecal_tpu_torch.io import dataset as tds
from sagecal_tpu_torch.rime import predict as trp
from sagecal_tpu_torch.rime import residual as trr
from sagecal_tpu_torch.solvers import lm as tlm
from sagecal_tpu_torch.solvers import normal_eq as tne


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_c2r_r2c_match_reference(as_tensor):
    x = _cplx(np.random.default_rng(0), (5, 2, 2))
    want = utils.c2r(x)
    got = tutils.c2r(torch.as_tensor(x) if as_tensor else x)
    got = got.numpy() if as_tensor else got
    np.testing.assert_array_equal(got, want)
    back = tutils.r2c(torch.as_tensor(got) if as_tensor else got)
    back = back.numpy() if as_tensor else back
    np.testing.assert_array_equal(back, np.asarray(utils.r2c(want)))


def test_row_tslot_matches_reference():
    np.testing.assert_array_equal(tds.row_tslot(45, 15), ds.row_tslot(45, 15))
    assert tds.row_tslot(45, 15).dtype == np.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtype_identities(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    assert np.dtype(dtp.acc_dtype(jdt)).itemsize == dtype.itemsize
    assert tdtp.acc_dtype(dtype) is dtype
    x = torch.ones(3, dtype=dtype)
    assert tdtp.to_storage(x, dtype) is x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reduced_dtypes_raise(dtype):
    """The reduced storage dtypes raised here until ``--dtype-policy
    bf16|f16`` was ported; now they map as the JAX package maps them: a
    float32 accumulator, and ``to_storage`` rounds to the dtype with the
    JAX package's bits."""
    jst = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    assert tdtp.acc_dtype(dtype) == torch.float32
    assert np.dtype(dtp.acc_dtype(jst)) == np.dtype(np.float32)
    x = torch.tensor([1.0 + 2.0 ** -9, 1.0 + 3.0 * 2.0 ** -12, 3.0])
    got = tdtp.to_storage(x, dtype)
    assert got.dtype == dtype
    want = dtp.to_storage(jnp.asarray(x.numpy()), jst).astype(jnp.float32)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_residual_writeback_matches_reference():
    res = _cplx(np.random.default_rng(1), (7, 3, 2, 2))
    want = np.asarray(rr.residual_writeback(jnp.asarray(res)))
    got = trr.residual_writeback(torch.as_tensor(res)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tutils.r2c(got), res)


@pytest.mark.parametrize("uvmin,uvmax", [(0.0, 1e9), (200.0, 700.0)])
def test_apply_uvcut_matches_reference(uvmin, uvmax):
    rng = np.random.default_rng(2)
    tile = types.SimpleNamespace(u=rng.normal(0, 3e-6, 60),
                                 v=rng.normal(0, 3e-6, 60),
                                 freqs=np.array([140e6, 160e6]))
    flags = rng.integers(0, 2, 60).astype(np.int8)
    kept = flags.copy()
    want = rp.apply_uvcut(flags, tile, uvmin, uvmax)
    got = trp.apply_uvcut(flags, tile, uvmin, uvmax)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(flags, kept)       # the input is a copy
    if uvmin > 0:
        assert (got == 2).any()


def test_weighted_cost_matches_reference():
    rng = np.random.default_rng(3)
    N, T, K = 5, 4, 2
    p, q = np.triu_indices(N, k=1)
    B = T * len(p)
    s1, s2 = np.tile(p, T), np.tile(q, T)
    cid = ((np.arange(B) // len(p)) * K // T).astype(np.int32)
    x8 = rng.normal(size=(B, 8))
    J = _cplx(rng, (K, N, 2, 2)) * 0.3 + np.eye(2)
    coh = _cplx(rng, (B, 2, 2))
    wt = rng.random((B, 8))
    want = np.asarray(ne.weighted_cost(*map(jnp.asarray,
                                            (x8, J, coh, s1, s2, cid, wt)),
                                       K))
    t = torch.as_tensor
    got = tne.weighted_cost(t(x8), t(J), t(coh), t(s1).long(), t(s2).long(),
                            t(cid), t(wt), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_executed_trips_matches_reference():
    info = {"solver_iters": 12, "lbfgs_iters": np.array([3, 4]),
            "res_0": 1.0}
    tinfo = {"solver_iters": 12, "lbfgs_iters": torch.tensor([3, 4]),
             "res_0": 1.0}
    assert tlm.executed_trips(tinfo) == lm_mod.executed_trips(info) == {
        "solver_iters": 12, "lbfgs_iters": 7}
    assert tlm.executed_trips(None) == lm_mod.executed_trips(None) == {}
