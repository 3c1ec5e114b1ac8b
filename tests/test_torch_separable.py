"""The port's separable-phasor rungs `cuda_v3` / `cuda_v4` / `cuda_v5` of
the gridder and the degridder, their precision policy and their guard,
against the JAX package and the f64 oracle on identical numpy inputs, at
small sizes on the CPU.

On a CPU staging the wrappers run their plain PyTorch versions, which take
the kernels' bf16 splits (ops/precision.py); the JAX side runs
`pallas_v3/v4/v5` through `idg_tpu.ops.api` in Pallas interpret mode. Gate:
the reference's 1e-5 normalized-RMS comparator. Cases: w = 0; the
`make_w_observation` default w and w_scale 45, both of which need rank 2 on
this problem, so that v4/v5's single bf16 pass carries the rank-1
correction with μ ≠ 0 (|μ·n| up to 1.3e-4 and 2.3e-3); and w_scale 1000,
where the guard escalates to rank 4 and every pass is bf16_3x.

Observed on the CPU, against the oracle: v3 3.5e-7 to 8.7e-7; v4/v5
8.7e-7 to 1.1e-6 (gridder) and 3.7e-6 to 4.0e-6 (degridder, the bf16_3x
split's own error: JAX's v4 gives 3.7e-6 there too). Against JAX: 1.8e-7
to 5.1e-7 in every case but v4/v5 at w_scale 45, where it is 3.2e-7 /
4.3e-7 (gridder) and 1.43e-6 / 1.46e-6 (degridder): JAX's CPU "default"
pass is float32, while the port, like the TPU, takes one bf16 pass. The
CUDA kernels meet these plain versions on the card, in
tests/test_torch_cuda.py and chip_smoke.py.

At every Taylor rank 1–6 the plain cuda_v3 / cuda_v4 meet JAX's
`pallas_v3_staged` / `pallas_v4_staged` forced to that rank, on the
w_scale 45 problem (both sides truncate the Taylor series alike, so they
agree at rank 1 too); the kernels on the card group ranks (two at a time
for v3, as many as fit shared memory for v4), and this holds their
yardstick to JAX at each. A ragged V (T = 37, C = 7, not a multiple of
the kernels' 32-visibility tiles) meets JAX and the oracle.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idg_tpu.data as jdata
import idg_tpu.ops.api as japi
import idg_tpu_torch.config as tcfg
import idg_tpu_torch.ops.api as tapi
from idg_tpu.ops.pallas.common import rank_precisions as jax_rank_precisions
from idg_tpu.ops.pallas.gridder import _dot_mixed
from idg_tpu.ops.pallas.gridder import gridder_precisions as jax_gridder_precisions
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.ops.cuda.gridder_separable import plain_precisions
from idg_tpu_torch.ops.precision import dot_mixed, round_tf32, split_tf32
from idg_tpu_torch.types import from_numpy_observation
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
VERSIONS = ("v3", "v4", "v5")
RANK2_W_SCALE = 45.0         # rank 2 with |μ·n| up to 2.3e-3, near rank 2's limit
ESCALATED_W_SCALE = 1000.0   # the guard picks rank 4 here (chip_smoke.py uses it too)
RAGGED = dict(nr_timesteps_subgrid=37, nr_channels=7)   # V = 259: ragged 32-visibility tiles


def _port(params):
    return tcfg.IDGParams(**dataclasses.asdict(params))


def _case(params, case):
    if case == "w0":
        obs, sub = jdata.make_observation(params, include_subgrids=True)
        return params, obs, sub
    w_scale = {"w_default": None, "w_rank2": RANK2_W_SCALE,
               "w_escalated": ESCALATED_W_SCALE}[case]
    return jdata.make_w_observation(params, w_scale=w_scale, include_subgrids=True)


def _port_run(workload, version, params, obs, sub):
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return tapi.run_gridder(tp, tobs, version, device="cpu")
    return tapi.run_degridder(tp, tobs, sub, version, device="cpu")


def _oracle(workload, params, obs, sub):
    tp, tobs = _port(params), from_numpy_observation(obs)
    if workload == "gridder":
        return gridder_reference(tp, tobs)
    return degridder_reference(tp, tobs, sub)


def _error(got, want):
    return check_error(got, want, verbose=False).mean_error


@pytest.mark.parametrize("mode", ["3x", "highest", "default", "3x2k"])
def test_dot_mixed_matches_jax(mode):
    """The port's split product against JAX's _dot_mixed on the same float32
    operands. For "default" JAX's CPU pass is float32, so the port's single
    bf16 pass is held against JAX's product of the bf16-cast operands, which
    is what the TPU computes."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 300)).astype(np.float32)
    b = rng.normal(size=(300, 96)).astype(np.float32)
    got = dot_mixed(torch.from_numpy(a), torch.from_numpy(b), mode).numpy()
    if mode == "default":
        want = np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                                  jnp.asarray(b).astype(jnp.bfloat16),
                                  preferred_element_type=jnp.float32))
        f32 = np.asarray(_dot_mixed(jnp.asarray(a), jnp.asarray(b), mode))
        assert np.abs(got - f32).max() > 1e-4 * np.abs(f32).max()   # bf16, not float32
    else:
        want = np.asarray(_dot_mixed(jnp.asarray(a), jnp.asarray(b), mode))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# the products per rank, [rows × depth] · [depth × cols]: K1's lhs_r [2N × V]
# · W [V × 2NP] and K2's lhs_r [4N × 2N] · rhs [2N × V], at V = 2048, N = 32
# and 16; and the direct rungs' skinny products (N = 8 columns, (p, re|im)):
# K8a's Φ [N² × 2TC] · vis [2TC × 8] and K9a's Φ [64 timesteps × 2N²] ·
# pixels [2N² × 8], at N = 32, T = 128, C = 16
TF32_PRODUCTS = [
    pytest.param(64, 256, 2048, id="64-256"), pytest.param(32, 128, 2048, id="32-128"),
    pytest.param(128, 2048, 64, id="k2-n32"), pytest.param(64, 2048, 32, id="k2-n16"),
    pytest.param(1024, 8, 4096, id="k8a"), pytest.param(64, 8, 2048, id="k9a"),
]


@pytest.mark.parametrize("rows,cols,depth", TF32_PRODUCTS)
def test_3xtf32_is_within_2e20_of_float64(rows, cols, depth):
    """"3xtf32", the product of the gridder K1, the degridder K2 and the
    direct rungs K8a and K9a (three TF32 passes), at their shapes on
    phasor-like operands: within 2⁻²⁰ of
    the float64 product in normwise relative error (its lo·lo term and lo's
    rounding are ~2⁻²², float32's accumulation the rest), and closer than
    "3x2k" (bf16 splits keep 2⁻¹⁷)."""
    rng = np.random.default_rng(rows + depth)
    lhs = np.cos(rng.uniform(0.0, 2 * np.pi, (rows, depth)))
    w = np.cos(rng.uniform(0.0, 2 * np.pi, (depth, cols))) * rng.normal(size=(depth, cols))
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (lhs, w))
    want = lhs.astype(np.float32).astype(np.float64) @ w.astype(np.float32).astype(np.float64)

    def error(mode):
        got = dot_mixed(a, b, mode)
        assert got.dtype == torch.float32
        return np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)

    assert error("3xtf32") <= 2.0 ** -20
    assert error("3xtf32") < error("3x2k")


@pytest.mark.parametrize("bits,rounded", [
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF803000, 0xBF804000),   # a tie, negative: away from zero
    (0xBF801001, 0xBF802000),   # past the tie, negative
    (0x3F800FFF, 0x3F800000),   # below the tie: down
    (0x3F802000, 0x3F802000),   # already TF32
])
def test_round_tf32_is_cvt_rna(bits, rounded):
    """round_tf32 rounds as K1's cvt.rna.tf32.f32: to nearest, ties away
    from zero."""
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = round_tf32(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == rounded


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e3, 1e20])
def test_split_tf32_reproduces_its_input(scale):
    """hi + lo = x to 2⁻²² relative, both parts with their 13 low mantissa
    bits clear (what the tensor cores read exactly)."""
    x = torch.from_numpy((np.random.default_rng(3).normal(size=4096) * scale).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    rel = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -22


@pytest.mark.parametrize("case", ["w0", "w_default", "w_rank2", "w_escalated"])
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_separable_matches_jax_and_oracle(workload, version, case, small_params):
    params, obs, sub = _case(small_params, case)
    rank = japi._resolve(workload, "pallas_" + version, params, obs)[1]
    assert (rank is not None and rank > 2) == (case == "w_escalated")
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


def _jax_staged(workload, version, params, obs, sub, rank):
    """JAX's `pallas_<version>_staged` at Taylor rank `rank`, staged as its
    perf harness stages it, in interpret mode; complex128 numpy."""
    import jax

    from idg_tpu.ops.pallas import STAGED
    from idg_tpu.types import split_complex, split_observation

    stage_fn, run_fn = STAGED[(workload, "pallas_" + version)]
    stg = jax.jit(lambda p, s: stage_fn(p, s, with_vis=workload == "gridder"),
                  static_argnums=0)(params, split_observation(obs))
    if workload == "gridder":
        re, im = run_fn(params, stg, interpret=True, w_rank=rank)
    else:
        re, im = run_fn(params, stg, split_complex(sub), interpret=True, w_rank=rank)
    return np.asarray(re) + 1j * np.asarray(im)


@pytest.fixture(scope="module")
def rank2_problem(small_params):
    return jdata.make_w_observation(small_params, w_scale=RANK2_W_SCALE, include_subgrids=True)


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("version", ["v3", "v4"])
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_separable_matches_jax_staged_at_every_rank(workload, version, rank, rank2_problem):
    """The plain cuda_v3 / cuda_v4 (what the kernels meet on the card)
    against JAX's staged pallas_v3 / pallas_v4 at the same forced rank,
    within the 1e-5 gate (observed: 1.9e-7 to 3.9e-7, and 1.43e-6 for the
    degridder v4 at rank 2, where its single bf16 pass meets JAX's float32
    CPU "default")."""
    params, obs, sub = rank2_problem
    tp, tobs = _port(params), from_numpy_observation(obs)
    stg = stage(tp, tobs, "cpu")
    wrapper = getattr(kernels, f"{workload}_cuda_{version}")
    if workload == "gridder":
        got = wrapper(tp, stg, rank)
    else:
        got = wrapper(tp, stg, torch.from_numpy(np.ascontiguousarray(sub)), rank)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _error(got, _jax_staged(workload, version, params, obs, sub, rank)) <= GATE


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_separable_ragged_v_matches_jax_and_oracle(workload, version, small_params):
    """V = 37·7 = 259 visibilities a subgrid: the kernels' last 32-visibility
    tile (v3/v4) and v5's last 32-timestep tile are ragged."""
    params = dataclasses.replace(small_params, **RAGGED)
    obs, sub = jdata.make_observation(params, include_subgrids=True)
    got = _port_run(workload, "cuda_" + version, params, obs, sub)
    if workload == "gridder":
        want = japi.run_gridder(params, obs, version="pallas_" + version)
    else:
        want = japi.run_degridder(params, obs, sub, version="pallas_" + version)
    assert _error(got, _oracle(workload, params, obs, sub)) <= GATE
    assert _error(got, want) <= GATE


@pytest.fixture(scope="module")
def many_channel_problem(small_params):
    """48 channels: the recurrence resyncs at c = 16 and 32
    (tests/test_guards.py:251-258)."""
    params = dataclasses.replace(small_params, nr_stations=2, nr_timesteps_subgrid=8,
                                 nr_channels=48)
    obs, sub = jdata.make_observation(params, include_subgrids=True)
    return params, obs, sub


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_v5_resyncs_at_many_channels(workload, many_channel_problem):
    params, obs, sub = many_channel_problem
    got = _port_run(workload, "cuda_v5", params, obs, sub)
    exact = _port_run(workload, "cuda_v4", params, obs, sub)
    assert not torch.equal(got, exact)              # the recurrence made its own Φ
    assert _error(got, _oracle(workload, params, obs, sub)) <= GATE


@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_v5_falls_back_on_non_uniform_channels(workload, small_params):
    """As JAX's pallas_v5 falls back to pallas_v4, cuda_v5 warns and runs
    cuda_v4, which meets the oracle."""
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    k = np.array(obs.wavenumbers, copy=True)
    k[-1] *= 1.05   # break uniform spacing (tests/test_guards.py:37-40)
    obs = dataclasses.replace(obs, wavenumbers=k)
    with pytest.warns(UserWarning, match="uniform channel spacing") as jax_record:
        assert japi._resolve(workload, "pallas_v5", small_params, obs) == ("pallas_v4", None)
    tp, tobs = _port(small_params), from_numpy_observation(obs)
    with pytest.warns(UserWarning, match="uniform channel spacing") as record:
        assert tapi._resolve(workload, "cuda_v5", tp, tobs) == ("cuda_v4", None)
    assert "falling back to pallas_v4" in str(jax_record[0].message)
    assert "falling back to cuda_v4" in str(record[0].message)
    with pytest.warns(UserWarning, match="falling back to cuda_v4"):
        got = _port_run(workload, "cuda_v5", small_params, obs, sub)
    assert torch.equal(got, _port_run(workload, "cuda_v4", small_params, obs, sub))
    assert _error(got, _oracle(workload, small_params, obs, sub)) <= GATE


@pytest.mark.parametrize("w_scale", [None, RANK2_W_SCALE, 50.0, 300.0, ESCALATED_W_SCALE])
@pytest.mark.parametrize("workload", ["gridder", "degridder"])
def test_rank_and_precisions_equal_jax(workload, w_scale, small_params):
    """The guard's rank for cuda_v3/v4/v5 is JAX's for pallas_v3/v4/v5, and
    the rank's precision policy is JAX's."""
    params, obs, _ = jdata.make_w_observation(small_params, w_scale=w_scale)
    tp, tobs = _port(params), from_numpy_observation(obs)
    jax_policy = jax_gridder_precisions if workload == "gridder" else jax_rank_precisions
    for version in VERSIONS:
        jax_rank = japi._resolve(workload, "pallas_" + version, params, obs)[1]
        version_t, rank = tapi._resolve(workload, "cuda_" + version, tp, tobs)
        assert (version_t, rank) == ("cuda_" + version, jax_rank)
        want = ("highest",) if version == "v3" else jax_policy(rank or 2)
        assert plain_precisions(version_t, rank or 2) == want


def test_cpu_tensors_leave_launch_counters_at_zero(small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu")
    subt = torch.from_numpy(np.ascontiguousarray(sub))
    kernels.reset_launch_counts()
    for version in VERSIONS:
        getattr(kernels, f"gridder_cuda_{version}")(params, stg)
        getattr(kernels, f"degridder_cuda_{version}")(params, stg, subt, 3)
    assert all(wrapper.launches == 0 for wrapper in kernels.KERNELS)


@pytest.mark.parametrize("bad", ["subgrid_size", "w_rank", "subgrids_shape"])
def test_separable_wrappers_reject_bad_input(bad, small_params):
    params = _port(small_params)
    obs, sub = jdata.make_observation(small_params, include_subgrids=True)
    stg = stage(params, from_numpy_observation(obs), "cpu")
    subt = torch.from_numpy(np.ascontiguousarray(sub))
    with pytest.raises(ValueError):
        if bad == "subgrid_size":
            kernels.gridder_cuda_v4(dataclasses.replace(params, subgrid_size=24), stg)
        elif bad == "w_rank":
            kernels.degridder_cuda_v5(params, stg, subt, 7)
        else:
            kernels.degridder_cuda_v3(params, stg, subt[:, :, :, :8])
