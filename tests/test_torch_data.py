"""The port's host layer against the JAX package's: glibc rand() draws, the
synthetic-observation generators, env-var config, and the numpy → port
observation carry-over. Everything here must be bit-identical."""

import dataclasses

import numpy as np
import pytest
import torch

import idg_tpu.config as jcfg
import idg_tpu.crand as jcrand
import idg_tpu.data as jdata
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.crand as tcrand
import idg_tpu_torch.data as tdata
from idg_tpu_torch.types import Observation, from_numpy_observation, to_device

_MD_FIELDS = ("time_offset", "nr_timesteps", "aterm_index", "station1",
              "station2", "coord_x", "coord_y", "coord_z")


def _port_params(jparams):
    return tcfg.IDGParams(**dataclasses.asdict(jparams))


def _assert_obs_equal(j, t):
    for name in ("uvw", "wavenumbers", "visibilities", "spheroidal", "aterms"):
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    for name in _MD_FIELDS:
        assert np.array_equal(np.asarray(getattr(j.metadata, name)),
                              np.asarray(getattr(t.metadata, name))), name


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 5])
def test_crand_draws_match(seed):
    j, t = jcrand.CRand(seed), tcrand.CRand(seed)
    assert np.array_equal(j.rand_array(2000), t.rand_array(2000))
    assert j.uniform() == t.uniform()


@pytest.mark.parametrize("which", ["small", "ref"])
def test_make_observation_matches(which, small_params, ref_params):
    jp = small_params if which == "small" else ref_params
    jobs, jsub = jdata.make_observation(jp, include_subgrids=True)
    tobs, tsub = tdata.make_observation(_port_params(jp), include_subgrids=True)
    _assert_obs_equal(jobs, tobs)
    assert np.array_equal(jsub, tsub)


def test_make_perf_observation_matches(small_params):
    _assert_obs_equal(jdata.make_perf_observation(small_params, seed=3),
                      tdata.make_perf_observation(_port_params(small_params), seed=3))


@pytest.mark.parametrize("w_scale", [None, 1000.0])
def test_make_w_observation_matches(w_scale, small_params):
    jp, jobs, _ = jdata.make_w_observation(small_params, w_scale=w_scale)
    tp, tobs, _ = tdata.make_w_observation(_port_params(small_params), w_scale=w_scale)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    _assert_obs_equal(jobs, tobs)


def test_initialize_subgrids_and_offsets_match(small_params):
    tp = _port_params(small_params)
    assert np.array_equal(jdata.initialize_subgrids(6, 4, 16),
                          tdata.initialize_subgrids(6, 4, 16))
    for a, b in zip(jdata.lmn_f64(16, 0.01), tdata.lmn_f64(16, 0.01)):
        assert np.array_equal(a, b)
    obs, _ = jdata.make_observation(small_params)
    for a, b in zip(jdata.uvw_offsets_f64(small_params, obs.metadata),
                    tdata.uvw_offsets_f64(tp, from_numpy_observation(obs).metadata)):
        assert np.array_equal(a, b)


def test_from_env_honours_env_vars(monkeypatch):
    env = {"GRID_SIZE": "2048", "SUBGRID_SIZE": "16", "NR_STATIONS": "7",
           "NR_TIMESLOTS": "3", "NR_TIMESTEPS_SUBGRID": "64", "NR_CHANNELS": "9",
           "NR_WARM_UP_RUNS": "4", "NR_ITERATIONS": "11", "NR_WINDOWS": "2",
           "OUTPUT_PATH": "/some/where"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls in ("IDGParams", "HarnessConfig"):
        j, t = getattr(jcfg, cls), getattr(tcfg, cls)
        assert dataclasses.asdict(j.from_env()) == dataclasses.asdict(t.from_env())
    assert (dataclasses.asdict(jcfg.IDGParams.correctness_defaults())
            == dataclasses.asdict(tcfg.IDGParams.correctness_defaults()))
    assert tcfg.IDGParams.from_env().nr_stations == 7


def test_from_numpy_observation_roundtrip(small_obs):
    obs = from_numpy_observation(small_obs)
    assert isinstance(obs, Observation)
    _assert_obs_equal(small_obs, obs)
    on_cpu = to_device(obs, "cpu")
    assert on_cpu.visibilities.dtype == torch.complex64
    assert on_cpu.metadata.station2.dtype == torch.int32
    _assert_obs_equal(small_obs, from_numpy_observation(
        Observation(**{f.name: getattr(on_cpu, f.name)
                       for f in dataclasses.fields(Observation)})))
