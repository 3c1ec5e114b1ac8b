"""The port's gridder/degridder main path against the f64 oracle and the JAX
flagships, on identical inputs, at small sizes on the CPU.

On a CPU staging the wrappers `gridder_cuda_v6` / `degridder_cuda_v7` run
their plain PyTorch versions; the JAX side runs `pallas_v6` / `pallas_v7`
through `idg_tpu.ops.api` in Pallas interpret mode, as its own tests do.
Gate: the reference's 1e-5 normalized-RMS comparator for both comparisons.
Observed on the CPU, over the three cases below:
- gridder: 5.7e-7 to 6.2e-7 against the oracle, 8.1e-7 to 8.3e-7 against
  JAX;
- degridder: 3.5e-7 to 5.9e-7 against the oracle, 4.2e-6 to 6.2e-6 against
  JAX (pallas_v7's K-merged bf16 split products drop the lo·lo term, so the
  JAX side is the farther of the two from the oracle). The CUDA kernels themselves meet their plain versions on
the card, in `-m cuda tests/test_torch_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import idg_tpu.data as jdata
import idg_tpu.ops.api as japi
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.ops.api as tapi
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.types import Metadata, from_numpy_observation
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
JAX_VERSION = {"gridder": "pallas_v6", "degridder": "pallas_v7"}
PORT_VERSION = {"gridder": "cuda_v6", "degridder": "cuda_v7"}
CASES = {
    # case: (params overrides, w_scale or "w0", rank the API must pick;
    # None is the kernels' default rank 2)
    "n32_odd_channels_w0": ({"subgrid_size": 32, "nr_channels": 7}, "w0", None),
    "n16_w_default_rank2": ({}, None, None),
    "n16_w1000_rank4": ({}, 1000.0, 4),
}


def _port(params):
    return tcfg.IDGParams(**dataclasses.asdict(params))


def _case(small_params, case):
    overrides, w_scale, _ = CASES[case]
    params = dataclasses.replace(small_params, **overrides)
    if w_scale == "w0":
        obs, sub = jdata.make_observation(params, include_subgrids=True)
    else:
        params, obs, sub = jdata.make_w_observation(
            params, w_scale=w_scale, include_subgrids=True)
    return params, obs, sub


def _run(workload, params, obs, sub, package):
    if package == "jax":
        if workload == "gridder":
            return japi.run_gridder(params, obs, version=JAX_VERSION[workload])
        return japi.run_degridder(params, obs, sub, version=JAX_VERSION[workload])
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return tapi.run_gridder(tp, tobs, PORT_VERSION[workload], device="cpu")
    return tapi.run_degridder(tp, tobs, sub, PORT_VERSION[workload], device="cpu")


def _oracle(workload, params, obs, sub):
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return gridder_reference(tp, tobs)
    return degridder_reference(tp, tobs, sub)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_port_matches_oracle_and_jax(workload, case, small_params):
    params, obs, sub = _case(small_params, case)
    rank = CASES[case][2]
    assert japi._resolve(workload, JAX_VERSION[workload], params, obs)[1] == rank
    assert tapi._resolve(workload, PORT_VERSION[workload], _port(params),
                         from_numpy_observation(obs))[1] == rank
    got = _run(workload, params, obs, sub, "torch")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    oracle = check_error(got, _oracle(workload, params, obs, sub), verbose=False)
    jax = check_error(got, _run(workload, params, obs, sub, "jax"), verbose=False)
    assert oracle.mean_error <= GATE, oracle
    assert jax.mean_error <= GATE, jax


@pytest.mark.parametrize("w_scale,rank", [(None, None), (1000.0, 4), (20000.0, "raise")])
def test_resolve_parity(w_scale, rank, small_params):
    """Same rank as idg_tpu.ops.api._resolve; both raise past MAX_W_RANK."""
    jp, jobs, _ = jdata.make_w_observation(small_params, w_scale=w_scale)
    tp, tobs = _port(jp), from_numpy_observation(jobs)
    assert tapi.required_w_rank(tp, tobs) == japi.required_w_rank(jp, jobs)
    for workload in ("gridder", "degridder"):
        if rank == "raise":
            with pytest.raises(ValueError):
                japi._resolve(workload, JAX_VERSION[workload], jp, jobs)
            with pytest.raises(ValueError, match="rank-6"):
                tapi._resolve(workload, PORT_VERSION[workload], tp, tobs)
        else:
            assert (tapi._resolve(workload, PORT_VERSION[workload], tp, tobs)
                    == (PORT_VERSION[workload], rank))


def test_non_uniform_channels_need_no_fallback(small_params):
    """The kernels make no channel-spacing assumption (uniform_channels is
    False), so perturbed wavenumbers run as they are and meet the oracle."""
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = from_numpy_observation(obs)
    k = obs.wavenumbers.copy()
    k[3] *= 1.01
    obs = dataclasses.replace(obs, wavenumbers=k)
    for workload in ("gridder", "degridder"):
        assert not tapi.get_kernel(workload, PORT_VERSION[workload]).uniform_channels
    got = tapi.run_gridder(params, obs, device="cpu")
    assert check_error(got, gridder_reference(params, obs), verbose=False).passed
    got = tapi.run_degridder(params, obs, sub, device="cpu")
    assert check_error(got, degridder_reference(params, obs, sub), verbose=False).passed


def test_gathered_time_offsets(small_params):
    """A non-canonical metadata order takes the staging's time gather."""
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = from_numpy_observation(obs)
    order = np.arange(obs.metadata.nr_subgrids)[::-1]
    md = Metadata(**{f.name: getattr(obs.metadata, f.name)[order]
                     for f in dataclasses.fields(Metadata)})
    obs = dataclasses.replace(obs, metadata=md)
    got = tapi.run_gridder(params, obs, device="cpu")
    assert check_error(got, gridder_reference(params, obs), verbose=False).passed


def test_cpu_tensors_leave_launch_counters_at_zero(small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = from_numpy_observation(obs)
    kernels.reset_launch_counts()
    tapi.run_gridder(params, obs, device="cpu")
    tapi.run_degridder(params, obs, sub, device="cpu")
    assert kernels.gridder_cuda_v6.launches == 0
    assert kernels.degridder_cuda_v7.launches == 0


@pytest.mark.parametrize("bad", ["subgrid_size", "w_rank", "subgrids_shape"])
def test_wrappers_reject_bad_input(bad, small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = from_numpy_observation(obs)
    stg = stage(params, obs, "cpu")
    subt = torch.from_numpy(np.ascontiguousarray(sub))
    with pytest.raises(ValueError):
        if bad == "subgrid_size":
            kernels.gridder_cuda_v6(dataclasses.replace(params, subgrid_size=24), stg)
        elif bad == "w_rank":
            kernels.degridder_cuda_v7(params, stg, subt, w_rank=7)
        else:
            kernels.degridder_cuda_v7(params, stg, subt[:, :, :, :8])
