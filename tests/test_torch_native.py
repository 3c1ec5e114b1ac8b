"""The port's native host runtime (idg_tpu_torch/native/): built with g++ at
first use, its glibc-rand stream equal draw for draw to the port's and the
JAX package's Python streams, and its oracles and comparator against the
port's NumPy ones. Skips only where g++ is missing, as tests/test_native.py
skips without a toolchain."""

import shutil

import numpy as np
import pytest

from idg_tpu.crand import CRand as JCRand
from idg_tpu_torch import native
from idg_tpu_torch.config import IDGParams
from idg_tpu_torch.crand import CRand, make_rng
from idg_tpu_torch.data import initialize_subgrids, make_observation
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.utils.compare import check_error

# glibc's draws for seeds with bit 31 set (tests/test_native.py:
# test_rand_stream_high_bit_seeds, verified there against compiled glibc)
HIGH_BIT_SEEDS = {
    3000000000: [2058147116, 854483408, 922419988, 286396165],
    2147483648: [1336741213, 1210407648, 1447044896, 337392383],
    4294967295: [254925627, 1205188300, 366127624, 1401405153],
}


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native host runtime cannot be built here")
    assert native.available()


@pytest.fixture(scope="module")
def small():
    params = IDGParams(grid_size=128, subgrid_size=16, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=16, nr_channels=8)
    obs, _ = make_observation(params)
    return params, obs


def test_build_lands_in_the_build_directory_and_is_cached():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT and lib.name == "libidg_native.so"
    mtime = lib.stat().st_mtime_ns
    assert native.build() == lib and lib.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("seed,n", [(0, 10000), (12345, 2000)])
def test_rand_stream_matches_python(seed, n):
    nat = native.NativeRand(seed).rand_array(n)
    assert np.array_equal(nat, CRand(seed).rand_array(n))
    assert np.array_equal(nat, JCRand(seed).rand_array(n))


@pytest.mark.parametrize("seed", sorted(HIGH_BIT_SEEDS))
def test_rand_stream_high_bit_seeds(seed):
    want = HIGH_BIT_SEEDS[seed]
    assert list(native.NativeRand(seed).rand_array(4)) == want
    assert list(CRand(seed).rand_array(4)) == want
    assert list(JCRand(seed).rand_array(4)) == want


def test_uniform_draws_match_python():
    nat = native.crand_uniform_array(7, 1000)
    assert np.array_equal(nat, CRand(7).uniform_array(1000))
    rng = native.NativeRand(7)
    assert rng.rand() == CRand(7).rand()


def test_native_gridder_matches_numpy_oracle(small):
    params, obs = small
    res = check_error(native.gridder_reference_native(params, obs),
                      gridder_reference(params, obs), verbose=False)
    assert res.passed and res.mean_error < 1e-6


def test_native_degridder_matches_numpy_oracle(small):
    params, obs = small
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    res = check_error(native.degridder_reference_native(params, obs, sub),
                      degridder_reference(params, obs, sub), verbose=False)
    assert res.passed and res.mean_error < 1e-6


def test_native_comparator_matches_python(small):
    params, obs = small
    a = gridder_reference(params, obs)
    b = a + (1e-6 + 2e-6j)
    assert abs(check_error(b, a, verbose=False).mean_error
               - native.check_error_native(b, a)) < 1e-12


def test_make_rng_prefers_native():
    rng = make_rng(0)
    assert isinstance(rng, native.NativeRand)
    assert np.array_equal(rng.rand_array(50), CRand(0).rand_array(50))


def test_make_rng_falls_back_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    rng = make_rng(3)
    assert type(rng) is CRand
    assert np.array_equal(rng.rand_array(20), JCRand(3).rand_array(20))
