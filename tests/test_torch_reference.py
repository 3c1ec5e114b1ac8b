"""The port's f64 golden oracle and comparator against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import idg_tpu.data as jdata
import idg_tpu.models.reference as jref
import idg_tpu.utils.compare as jcmp
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.models.reference as tref
import idg_tpu_torch.utils.compare as tcmp
from idg_tpu_torch.types import from_numpy_observation


def _inputs(small_params, kind):
    if kind == "w0":
        obs, sub = jdata.make_observation(small_params, include_subgrids=True)
        params = small_params
    else:
        params, obs, sub = jdata.make_w_observation(small_params, include_subgrids=True)
    return params, obs, sub, tcfg.IDGParams(**dataclasses.asdict(params))


@pytest.mark.parametrize("kind", ["w0", "w"])
def test_gridder_oracle_matches(kind, small_params):
    jp, jobs, _, tp = _inputs(small_params, kind)
    want = jref.gridder_reference(jp, jobs)
    got = tref.gridder_reference(tp, from_numpy_observation(jobs))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", ["w0", "w"])
def test_degridder_oracle_matches(kind, small_params):
    jp, jobs, sub, tp = _inputs(small_params, kind)
    want = jref.degridder_reference(jp, jobs, sub)
    got = tref.degridder_reference(tp, from_numpy_observation(jobs), sub)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("scale", [1e-7, 1e-3])
def test_check_error_matches(scale, rng):
    """Same mean_error and verdict on the same arrays, numpy or tensor."""
    ref = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    ref[::7] = 0
    cmp = (ref + scale * (rng.standard_normal(512) + 1j * rng.standard_normal(512))
           ).astype(np.complex64)
    want = jcmp.check_error(cmp, ref, verbose=False)
    for a in (cmp, torch.from_numpy(cmp)):
        got = tcmp.check_error(a, ref, verbose=False)
        assert got.mean_error == want.mean_error
        assert got.passed == want.passed
        assert got.nnz == want.nnz
