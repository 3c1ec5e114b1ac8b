"""The port's exact full-phase path (gridder and degridder `cuda_v1` /
`cuda_v2`), the API guard's fallbacks, the w-free rungs (`cuda_v7` gridder,
`cuda_v8` degridder), `sweep` and `vadd`, against the JAX package and the f64
oracle on identical numpy inputs, at small sizes on the CPU.

On a CPU staging the port's wrappers run their plain PyTorch versions; the
JAX side runs `pallas_v1` / `pallas_v2` through `idg_tpu.ops.api` in Pallas
interpret mode, as its own tests do. Gate: the reference's 1e-5
normalized-RMS comparator for both comparisons, at w = 0, at
make_w_observation's default w and at w = 2·10⁴ (no Taylor rank reaches
that; the direct kernels are exact in w). Observed on the CPU: 5.3e-7 to
1.3e-6 against the oracle, 3.5e-7 to 5.6e-7 against JAX. The CUDA kernels
meet their plain versions on the card, in `-m cuda tests/test_torch_cuda.py`.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idg_tpu.config as jcfg
import idg_tpu.data as jdata
import idg_tpu.ops.api as japi
import idg_tpu.ops.registry as jregistry
import idg_tpu.ops.vadd as jvadd
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.ops.api as tapi
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops import vadd as tvadd
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.ops.cuda.degridder import jones_degridder
from idg_tpu_torch.ops.cuda.gridder import _station_jones, jones_gridder
from idg_tpu_torch.ops.cuda.gridder_direct import (CHANNEL_GROUP, channel_step,
                                                   direct_geometry, expi, fma32,
                                                   gridder_phase)
from idg_tpu_torch.ops.precision import dot_mixed
from idg_tpu_torch.ops.registry import get_kernel, list_kernels
from idg_tpu_torch.types import from_numpy_observation
from idg_tpu_torch.utils.compare import check_error

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATE = 1e-5
STRESS_W = 2.0e4
# port rung, the rank-taking kernel it runs at rank 1, its fallback, JAX rung
W_FREE = {"gridder": ("cuda_v7", "cuda_v6", "cuda_v4", "pallas_v7"),
          "degridder": ("cuda_v8", "cuda_v7", "cuda_v4", "pallas_v8")}
TAKES_RANK = {"gridder": "cuda_v6", "degridder": "cuda_v7"}


def _port(params):
    return tcfg.IDGParams(**dataclasses.asdict(params))


def _stress_w(obs, w_value):
    """Constant w with no compensating w plane (tests/test_guards.py:104-108)."""
    uvw = np.array(obs.uvw, copy=True)
    uvw[:, :, 2] = w_value
    return dataclasses.replace(obs, uvw=uvw)


def _non_uniform(obs):
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05   # break uniform spacing in the last channel (tests/test_guards.py:37-40)
    return dataclasses.replace(obs, wavenumbers=k)


def _case(small_params, case):
    if case == "w_default":
        return jdata.make_w_observation(small_params, include_subgrids=True)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    return small_params, (_stress_w(obs, STRESS_W) if case == "w2e4" else obs), sub


def _port_run(workload, version, params, obs, sub, w_rank=None):
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return tapi.run_gridder(tp, tobs, version, w_rank=w_rank, device="cpu")
    return tapi.run_degridder(tp, tobs, sub, version, w_rank=w_rank, device="cpu")


def _oracle(workload, params, obs, sub):
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return gridder_reference(tp, tobs)
    return degridder_reference(tp, tobs, sub)


def _error(got, want):
    return check_error(got, want, verbose=False).mean_error


@pytest.mark.parametrize("case", ["w0", "w_default", "w2e4"])
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_direct_matches_jax_and_oracle(workload, version, case, small_params):
    """cuda_v1/v2 against pallas_v1/v2 and the oracle; no guard engages on a
    direct kernel, at any w."""
    params, obs, sub = _case(small_params, case)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _port_run(workload, "cuda_" + version, params, obs, sub)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    if workload == "gridder":
        want = japi.run_gridder(params, obs, version="pallas_" + version)
    else:
        want = japi.run_degridder(params, obs, sub, version="pallas_" + version)
    assert _error(got, _oracle(workload, params, obs, sub)) <= GATE
    assert _error(got, want) <= GATE


def test_gridder_recurrence_holds_the_gate_at_256_channels(small_params):
    """The smallest problem that shows pallas_v2's drift (N = 16, T = 8,
    C = 256): JAX's gridder recurrence never restarts and misses the gate
    against the oracle (4.4e-5); the port's cuda_v2 restarts exactly every 8
    channels, as its degridder does, and holds it (2.9e-6)."""
    params = dataclasses.replace(small_params, nr_timesteps_subgrid=8, nr_channels=256)
    obs, sub = jdata.make_observation(params, include_subgrids=True)
    oracle = _oracle("gridder", params, obs, sub)
    assert _error(_port_run("gridder", "cuda_v2", params, obs, sub), oracle) <= GATE
    assert _error(japi.run_gridder(params, obs, version="pallas_v2"), oracle) > GATE


@pytest.mark.parametrize("problem, jax_version", [("correctness", "pallas_v1"),
                                                  ("c256", "xla_reference"),
                                                  ("small_c256", "pallas_v1")])
def test_gridder_v1_phase_is_as_accurate_as_jax(problem, jax_version):
    """The plain gridder cuda_v1 forms its float32 phase with the roundings of
    JAX's direct kernel as XLA compiles it (fused multiply-adds,
    gridder_direct.py:direct_geometry, gridder_phase), so its error against
    the oracle is at most 1.08× JAX's on the same inputs: on the correctness
    problem (N = 32, T = 128, C = 16) against pallas_v1 in interpret mode
    (2.133e-06 against 2.014e-06 observed), at C = 256, N = 16 against
    xla_reference (1.258e-05 against 1.401e-05; pallas_v1's interpret trace
    takes minutes there), and on the card tests' small C = 256 problem (6
    subgrids) against pallas_v1 (3.575e-06 against 4.136e-06). Rounded one
    operation at a time, the phase gave 2.317e-06, 1.686e-05 and 3.451e-06."""
    params = jcfg.IDGParams.correctness_defaults()
    if problem == "c256":
        params = dataclasses.replace(params, subgrid_size=16, nr_channels=256)
    elif problem == "small_c256":
        params = jcfg.IDGParams(subgrid_size=16, nr_channels=256, grid_size=128,
                                nr_stations=3, nr_timeslots=2, nr_timesteps_subgrid=16)
    obs, sub = jdata.make_observation(params, include_subgrids=True)
    oracle = _oracle("gridder", params, obs, sub)
    got = _error(_port_run("gridder", "cuda_v1", params, obs, sub), oracle)
    want = _error(japi.run_gridder(params, obs, version=jax_version), oracle)
    assert got <= 1.08 * want, (got, want)


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_recurrence_falls_back_on_non_uniform_channels(workload, small_params):
    """As JAX's pallas_v2 falls back to pallas_v1, cuda_v2 warns and runs
    cuda_v1, which meets the oracle; the raw recurrence misses the gate."""
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = _non_uniform(obs)
    with pytest.warns(UserWarning, match="uniform channel spacing"):
        assert japi._resolve(workload, "pallas_v2", small_params, obs) == ("pallas_v1", None)
    tp, tobs = _port(small_params), from_numpy_observation(obs)
    with pytest.warns(UserWarning, match="uniform channel spacing.*falling back to cuda_v1"):
        assert tapi._resolve(workload, "cuda_v2", tp, tobs) == ("cuda_v1", None)
    oracle = _oracle(workload, small_params, obs, sub)
    with pytest.warns(UserWarning, match="uniform channel spacing"):
        got = _port_run(workload, "cuda_v2", small_params, obs, sub)
    assert _error(got, oracle) <= GATE
    stg = stage(tp, tobs, "cpu")
    if workload == "gridder":
        raw = kernels.gridder_direct_plain(tp, stg, True)
    else:
        raw = kernels.degridder_direct_plain(tp, stg, torch.from_numpy(sub), True)
    assert _error(raw, oracle) > GATE


@pytest.mark.parametrize("override", [None, 2])
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_w_free_rungs_fall_back_on_nonzero_w(workload, override, small_params):
    """At w = 600 rank 1 is short: both packages warn "w-free" (and that an
    override is ignored) and fall back to a rank-taking rung at the same
    rank; the port's result meets the oracle."""
    rung, _, fallback, jax_rung = W_FREE[workload]
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    obs = _stress_w(obs, 600.0)
    with pytest.warns(UserWarning) as jax_record:
        jax_version, jax_rank = japi._resolve(workload, jax_rung, small_params, obs, override)
    assert jax_version == "pallas_v4"
    with pytest.warns(UserWarning) as record:
        got = _port_run(workload, rung, small_params, obs, sub, w_rank=override)
    for rec, to in ((jax_record, "pallas_v4"), (record, fallback)):
        messages = [str(w.message) for w in rec]
        assert any("w-free" in m and f"falling back to {to}" in m for m in messages), messages
        assert any("override is ignored" in m for m in messages) == (override is not None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resolved = tapi._resolve(workload, rung, _port(small_params),
                                 from_numpy_observation(obs), override)
    assert resolved == (fallback, jax_rank) and jax_rank > 1
    assert _error(got, _oracle(workload, small_params, obs, sub)) <= GATE


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_w_free_rungs_at_w0_are_the_rank1_kernel(workload, small_params):
    rung, rank1_kernel, _, _ = W_FREE[workload]
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    tp, tobs = _port(small_params), from_numpy_observation(obs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tapi._resolve(workload, rung, tp, tobs) == (rung, None)
        got = _port_run(workload, rung, small_params, obs, sub)
    want = _port_run(workload, rank1_kernel, small_params, obs, sub, w_rank=1)
    assert torch.equal(got, want)
    assert _error(got, _oracle(workload, small_params, obs, sub)) <= GATE


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_beyond_rank_6_raises_and_names_cuda_v1(workload, small_params):
    """At w = 2·10⁴ the rank-taking and w-free rungs raise in both packages
    (cuda_v1 runs there: test_direct_matches_jax_and_oracle)."""
    obs, _ = jdata.make_observation(small_params)
    obs = _stress_w(obs, STRESS_W)
    tp, tobs = _port(small_params), from_numpy_observation(obs)
    with pytest.raises(ValueError, match="direct full-phase"):
        japi._resolve(workload, "pallas_v4", small_params, obs)
    with pytest.raises(ValueError,
                       match=r"rank-6 Taylor.*direct full-phase kernel \(cuda_v1 / torch_v2\)"):
        tapi._resolve(workload, TAKES_RANK[workload], tp, tobs)
    with pytest.raises(ValueError, match="w-free"):
        japi._resolve(workload, W_FREE[workload][3], small_params, obs)
    with pytest.raises(ValueError,
                       match=r"w-free.*direct full-phase kernel \(cuda_v1 / torch_v2\)"):
        tapi._resolve(workload, W_FREE[workload][0], tp, tobs)


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_direct_kernels_ignore_a_rank_override(workload, small_params):
    obs, _ = jdata.make_observation(small_params)
    with pytest.warns(UserWarning, match="override is ignored"):
        assert japi._resolve(workload, "pallas_v1", small_params, obs, 3) == ("pallas_v1", None)
    with pytest.warns(UserWarning, match="override is ignored"):
        assert tapi._resolve(workload, "cuda_v1", _port(small_params),
                             from_numpy_observation(obs), 3) == ("cuda_v1", None)


@pytest.mark.parametrize("workload,version,uniform,fallback,fixed,takes_rank", [
    ("gridder", "cuda_v1", False, None, None, False),
    ("gridder", "cuda_v2", True, "cuda_v1", None, False),
    ("gridder", "cuda_v3", False, None, None, True),
    ("gridder", "cuda_v4", False, None, None, True),
    ("gridder", "cuda_v5", True, "cuda_v4", None, True),
    ("gridder", "cuda_v6", False, None, None, True),
    ("gridder", "cuda_v7", False, "cuda_v4", 1, False),
    ("degridder", "cuda_v1", False, None, None, False),
    ("degridder", "cuda_v2", True, "cuda_v1", None, False),
    ("degridder", "cuda_v3", False, None, None, True),
    ("degridder", "cuda_v4", False, None, None, True),
    ("degridder", "cuda_v5", True, "cuda_v4", None, True),
    ("degridder", "cuda_v6", True, "cuda_v4", None, True),
    ("degridder", "cuda_v7", False, None, None, True),
    ("degridder", "cuda_v8", False, "cuda_v4", 1, False),
])
def test_registry_entries(workload, version, uniform, fallback, fixed, takes_rank):
    entry = get_kernel(workload, version)
    assert (entry.family, entry.uniform_channels, entry.fallback, entry.fixed_w_rank) == (
        "cuda", uniform, fallback, fixed)
    assert tapi._accepts(workload, version, "w_rank") == takes_rank


# The one expected difference from JAX's guards: K1/K2's exact-phase rungs
# take no channel recurrence, so they are not uniform_channels, and gridder
# cuda_v6 / degridder cuda_v7 register no fallback, since theirs served only
# the channel guard (ROADMAP Queue 3).
EXACT_PHASE_RUNGS = {("gridder", "cuda_v6"), ("gridder", "cuda_v7"),
                     ("degridder", "cuda_v7"), ("degridder", "cuda_v8")}


PALLAS_RUNGS = [("gridder", f"pallas_v{i}") for i in range(1, 8)] + [
    ("degridder", f"pallas_v{i}") for i in range(1, 9)]


@pytest.mark.parametrize("workload,jax_version", PALLAS_RUNGS)
def test_guards_match_jax_rung_for_rung(workload, jax_version):
    """Each JAX pallas_vN and the port's cuda_vN: the same uniform_channels,
    fallback (pallas_vK -> cuda_vK) and fixed_w_rank, but for the listed
    exact-phase rungs. PALLAS_RUNGS is every pallas rung JAX registers."""
    assert sorted((e.workload, e.version) for e in jregistry.list_kernels()
                  if e.family == "pallas") == sorted(PALLAS_RUNGS)
    jax_entry = jregistry.get_kernel(workload, jax_version)
    version = jax_version.replace("pallas_", "cuda_")
    entry = get_kernel(workload, version)
    want = (jax_entry.uniform_channels,
            jax_entry.fallback and jax_entry.fallback.replace("pallas_", "cuda_"),
            jax_entry.fixed_w_rank)
    if (workload, version) in EXACT_PHASE_RUNGS:
        want = (False, None if entry.fixed_w_rank is None else want[1], want[2])
    assert (entry.uniform_channels, entry.fallback, entry.fixed_w_rank) == want


def test_cpu_tensors_leave_launch_counters_at_zero(small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu")
    kernels.reset_launch_counts()
    for wrapper in (kernels.gridder_cuda_v1, kernels.gridder_cuda_v2):
        wrapper(params, stg)
    for wrapper in (kernels.degridder_cuda_v1, kernels.degridder_cuda_v2):
        wrapper(params, stg, torch.from_numpy(np.ascontiguousarray(sub)))
    kernels.vadd_cuda(*tvadd.make_vadd_inputs(8))
    assert all(wrapper.launches == 0 for wrapper in kernels.KERNELS)


@pytest.mark.parametrize("bad", ["subgrid_size", "subgrids_shape", "staging_dtype"])
def test_direct_wrappers_reject_bad_input(bad, small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu")
    subt = torch.from_numpy(np.ascontiguousarray(sub))
    with pytest.raises(ValueError):
        if bad == "subgrid_size":
            kernels.gridder_cuda_v1(dataclasses.replace(params, subgrid_size=24), stg)
        elif bad == "subgrids_shape":
            kernels.degridder_cuda_v2(params, stg, subt[:, :, :, :8])
        else:
            kernels.vadd_cuda(torch.zeros(8), torch.zeros(8, dtype=torch.float64))


@pytest.mark.parametrize("n", [4099, 1 << 16])
def test_vadd_plain_matches_jax(n):
    jx, jy = jvadd.make_vadd_inputs(n)
    x, y = tvadd.make_vadd_inputs(n)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    want = np.asarray(jvadd.vadd(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    np.testing.assert_array_equal(tvadd.vadd_plain(x, y).numpy(), want)
    np.testing.assert_array_equal(kernels.vadd_cuda(x, y).numpy(), want)
    assert tvadd.vadd_gbytes(n) == jvadd.vadd_gbytes(n)


def test_sweep_check_on_cpu_passes_every_version():
    out = subprocess.run(
        [sys.executable, "-m", "idg_tpu_torch", "sweep", "--mode", "check", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    versions = [(e.workload, e.version) for e in list_kernels()]
    for workload, version in versions:
        assert f"=== {workload} {version} (check) ===" in out.stdout
    assert len(versions) == 25   # the 15 cuda_* rungs and the ten torch_* of the ladder
    assert out.stdout.count(">>> Result PASSED") == len(versions)


def _cmatmul_3xtf32(a, b):
    """Complex a [.., M, K] @ b [.., K, N] as the direct kernels lay it out for
    the TF32 tensor cores: the real product [a_re | a_im] · [[b_re, b_im],
    [−b_im, b_re]] (K8a: a = Φ, b = the visibilities; K9a: a = Φ, b = the
    prepared pixels), taken as "3xtf32"."""
    n = b.shape[-1]
    lhs = torch.cat([a.real, a.imag], dim=-1)
    rhs = torch.cat([torch.cat([b.real, b.imag], dim=-1),
                     torch.cat([-b.imag, b.real], dim=-1)], dim=-2)
    out = dot_mixed(lhs.float().contiguous(), rhs.float().contiguous(), "3xtf32")
    return torch.complex(out[..., :n], out[..., n:])


def _direct_3xtf32(workload, params, stg, sub, recurrence):
    """The plain direct rung (ops/cuda/{gridder,degridder}_direct.py: the same
    phases, phasors and recurrence) with its float32 contraction replaced
    by the kernels' "3xtf32" product, in one chunk of subgrids."""
    S, T, C = stg.nr_subgrids, params.nr_timesteps_subgrid, params.nr_channels
    N, P = params.subgrid_size, params.nr_correlations
    k = stg.wavenumbers
    pi, po = direct_geometry(stg, 0, S)                          # [S,T,NN], [S,1,NN]
    a1, a2 = _station_jones(stg, 0, S)
    sign = -1.0 if workload == "gridder" else 1.0
    step = expi(sign * pi * channel_step(k))
    groups = range(0, C, CHANNEL_GROUP) if recurrence else [None]
    if workload == "gridder":
        pix = 0
        for c0 in groups:
            chans = range(c0, min(c0 + CHANNEL_GROUP, C)) if recurrence else range(C)
            ph = expi(gridder_phase(pi, k[chans[0]], po)) if recurrence else None
            for c in chans:
                ph = ph if recurrence else expi(gridder_phase(pi, k[c], po))
                # Φᵀ [s, NN, T] · vis [s, T, P]
                pix = pix + _cmatmul_3xtf32(ph.transpose(1, 2), stg.vis[:, :, c])
                if recurrence:
                    ph = ph * step
        pix = jones_gridder(pix.reshape(S, N, N, P), a1, a2) * stg.sph[None, :, :, None]
        return pix.permute(0, 3, 1, 2)
    pix = sub.permute(0, 2, 3, 1) * stg.sph[None, :, :, None]
    pix = jones_degridder(pix, a1, a2).reshape(S, N * N, P)
    out = torch.empty((S, T, C, P), dtype=torch.complex64)
    for c0 in groups:
        chans = range(c0, min(c0 + CHANNEL_GROUP, C)) if recurrence else range(C)
        ph = expi(-gridder_phase(pi, k[chans[0]], po)) if recurrence else None
        for c in chans:
            ph = ph if recurrence else expi(-gridder_phase(pi, k[c], po))
            out[:, :, c] = _cmatmul_3xtf32(ph, pix)                # [s,T,NN] · [s,NN,P]
            if recurrence:
                ph = ph * step
    return out


@pytest.mark.parametrize("case", ["w0", "w2e4", "c256"])
@pytest.mark.parametrize("recurrence", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_direct_contraction_on_3xtf32_holds_the_oracle(workload, recurrence, case, small_params):
    """The direct rungs with their complex MAC taken as the kernels take it
    on the TF32 tensor cores (three passes, "3xtf32") in place of the plain
    version's float32 einsum: against the f64 oracle within the 1e-5 gate,
    and within 4e-7 of the float32 contraction's own error (the TF32 split
    keeps ~2^-21 of each operand; the float32 phases, the same in both, set
    the error: 5.3e-7 to 3.0e-6 observed, the two apart by 2.0e-7 at most,
    gridder v1 at C = 256). C = 256 at T = 8 holds 32 restarts of the
    recurrence."""
    if case == "c256":
        small_params = dataclasses.replace(small_params, nr_timesteps_subgrid=8,
                                           nr_channels=256)
        case = "w0"
    params, obs, sub = _case(small_params, case)
    tp, tobs = _port(params), from_numpy_observation(obs)
    stg = stage(tp, tobs, "cpu")
    sub_t = torch.from_numpy(np.ascontiguousarray(sub))
    got = _direct_3xtf32(workload, tp, stg, sub_t, recurrence)
    if workload == "gridder":
        plain = kernels.gridder_direct_plain(tp, stg, recurrence)
    else:
        plain = kernels.degridder_direct_plain(tp, stg, sub_t, recurrence)
    oracle = _oracle(workload, params, obs, sub)
    err, err_plain = _error(got, oracle), _error(plain, oracle)
    assert err <= GATE
    assert abs(err - err_plain) <= 4e-7


def _kernel_constants():
    """The float constants of csrc/common.cuh, by name."""
    text = (ROOT / "idg_tpu_torch" / "csrc" / "common.cuh").read_text()
    return {name: np.float32(value) for name, value in
            re.findall(r"constexpr float (k\w+) = ([-+0-9.eE]+)f;", text)}


def _fma32(a, b, c):
    """fmaf in float32 on numpy values, by the port's own emulation
    (gridder_direct.fma32)."""
    return fma32(*(torch.from_numpy(np.asarray(v, np.float32)) for v in (a, b, c))).numpy()


def _stress_phases():
    """Every float32 phase po − pi·k (one FMA) of the correctness problem (N = 32,
    T = 128, C = 16) at w = 2·10⁴, as the port forms it (plain version)."""
    from idg_tpu_torch.data import make_observation

    params = tcfg.IDGParams.correctness_defaults()
    obs, _ = make_observation(params)
    stg = stage(params, _stress_w(obs, STRESS_W), "cpu")
    pi, po = direct_geometry(stg, 0, stg.nr_subgrids)
    return gridder_phase(pi[:, :, None], stg.wavenumbers[:, None], po[:, :, None]).numpy().ravel()


@pytest.mark.parametrize("model", ["reduced", "poly"])
def test_phasor_reduction_model_holds_1e6(model):
    """A model of the kernels' exact phasors with the constants of
    csrc/common.cuh: expi_reduced takes k = round(x / 2π) by adding 1.5·2^23
    and r = x − k·2π_hi − k·2π_lo in two FMAs, then the SFU on r (modelled
    exactly: the SFU's own 2^-21.4 is the card's); expi_poly reduces by π/2
    and evaluates the Cephes polynomials, quadrant from the sum's low bits.
    On every phase of the correctness problem at w = 2·10⁴, cos and sin are
    within 1e-6 of numpy's on the float32 phase (~30 rad at most),
    and on float32 phases up to 10⁴ rad; |r| stays within π (π/4) but for
    the rounding of x / 2π (x / (π/2)) to float32, ~1e-4 at 10⁴ rad."""
    const = _kernel_constants()
    x = _stress_phases()
    assert np.abs(x).max() > 25.0
    # and far past them: |x| up to 10⁴ rad
    x = np.concatenate([x, np.linspace(-1e4, 1e4, 200_001, dtype=np.float32)])
    big = const["kRoundInt"]
    if model == "reduced":
        t = _fma32(x, const["kInv2Pi"], big)
        q = (t - big).astype(np.float32)
        r = _fma32(-q, const["k2PiLo"], _fma32(-q, const["k2PiHi"], x))
        assert np.abs(r).max() <= np.pi + 1e-3
        cs, sn = np.cos(r.astype(np.float64)), np.sin(r.astype(np.float64))
    else:
        t = _fma32(x, const["k2OverPi"], big)
        q = (t - big).astype(np.float32)
        r = _fma32(-q, const["kHalfPiLo"], _fma32(-q, const["kHalfPiHi"], x))
        assert np.abs(r).max() <= np.pi / 4 + 1e-3
        z = (r * r).astype(np.float32)
        sn = _fma32(_fma32(_fma32(np.float32(-1.9515295891e-4), z, np.float32(8.3321608736e-3)),
                           z, np.float32(-1.6666654611e-1)), (z * r).astype(np.float32), r)
        cs = _fma32(_fma32(_fma32(np.float32(2.443315711809948e-5), z,
                                  np.float32(-1.388731625493765e-3)), z,
                           np.float32(4.166664568298827e-2)), (z * z).astype(np.float32),
                    _fma32(np.float32(-0.5), z, np.float32(1.0)))
        iq = t.view(np.int32)
        cs, sn = np.where(iq & 1, -sn, cs), np.where(iq & 1, cs, sn)
        cs, sn = np.where(iq & 2, -cs, cs), np.where(iq & 2, -sn, sn)
    x64 = x.astype(np.float64)
    assert np.abs(cs - np.cos(x64)).max() <= 1e-6
    assert np.abs(sn - np.sin(x64)).max() <= 1e-6


def _oracle_errors_by_step(monkeypatch, workload, versions, step):
    """Each version's plain error against the oracle on the correctness
    problem (w = 0), its recurrence stepped by `step` (None: the port's)."""
    from idg_tpu_torch.data import initialize_subgrids, make_observation
    from idg_tpu_torch.ops.cuda import degridder_direct, gridder_direct

    if step is not None:
        for module in (gridder_direct, degridder_direct):
            monkeypatch.setattr(module, "channel_step", step)
    params = tcfg.IDGParams.correctness_defaults()
    obs, _ = make_observation(params)
    if workload == "gridder":
        want = gridder_reference(params, obs)
        return [_error(tapi.run_gridder(params, obs, v, device="cpu"), want) for v in versions]
    sub = initialize_subgrids(params.nr_subgrids, params.nr_correlations, params.subgrid_size)
    want = degridder_reference(params, obs, sub)
    return [_error(tapi.run_degridder(params, obs, sub, v, device="cpu"), want)
            for v in versions]


def _k1_minus_k0(k):
    return k[1] - k[0] if k.shape[0] > 1 else torch.zeros((), dtype=k.dtype)


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_recurrence_steps_by_the_uniform_fit(workload, monkeypatch):
    """cuda_v2 steps by the uniform fit's Δk (channel_step): on the
    correctness problem the plain gridder's error falls from 4.3e-6 with
    k[1] − k[0] to within 1.2× cuda_v1's (K8a on an H100: 4.422e-06 →
    2.327e-06, cuda_v1 2.169e-06), and the degridder's does not rise."""
    v1, v2 = _oracle_errors_by_step(monkeypatch, workload, ("cuda_v1", "cuda_v2"), None)
    (v2_k1_minus_k0,) = _oracle_errors_by_step(monkeypatch, workload, ("cuda_v2",),
                                               _k1_minus_k0)
    assert v2 <= v2_k1_minus_k0, (v2, v2_k1_minus_k0)
    if workload == "gridder":
        assert v2_k1_minus_k0 > 4e-6 and v2 <= 1.2 * v1, (v1, v2, v2_k1_minus_k0)


def test_channel_step_is_the_uniform_fit():
    from idg_tpu_torch.ops.cuda.gridder_direct import wavenumbers_and_step

    k = torch.tensor([1.0, 1.25, 1.5, 1.75, 2.0], dtype=torch.float32)
    assert float(channel_step(k)) == 0.25
    k = torch.linspace(8.1, 9.7, 16, dtype=torch.float32)
    assert channel_step(k) == (k[-1] - k[0]) / 15
    assert float(channel_step(k[:1])) == 0.0
    k_dk = wavenumbers_and_step(k)   # what the recurrence kernels read: Δk = k[C]
    assert k_dk.shape == (17,) and torch.equal(k_dk[:16], k)
    assert k_dk[16] == channel_step(k)
