"""The port's multi-device layer (idg_tpu_torch/parallel/) against the port's
single-device composition, the JAX package's sharded results and the f64
oracle, on the CPU.

Three gloo worlds are spawned once, together, by `torch.distributed.run`
(`--standalone` picks a free port, so xdist workers do not collide):

  world2   2 ranks, 1-D mesh, 40 subgrids, `parallel/parity.py` with the
           version pairs torch_v2/torch_v2 (JAX xla_v2's counterpart) and
           cuda_v6/cuda_v7 (their plain versions on CPU tensors)
  world4   4 ranks, the ("host", "chip") 2 × 2 mesh, 30 subgrids (an odd
           count: the tail shard pads to 32), cuda_v6/cuda_v7
  scaling  2 ranks, `python -m idg_tpu_torch scaling --mesh-sizes 1,2
           --device cpu` on the same small problem

parity.py itself raises on a miss; here each rank's gathered outputs
(`--out`) are held again against: the port's single-device composition on
the same inputs (grids max-rel 1e-6: only the order of the sum of partials
differs; subgrids and visibilities the 1e-5 normalized-RMS gate); the JAX
package's own sharded pipelines on make_mesh(2) and
make_hier_mesh(chips_per_host=2) over conftest's 8 virtual devices (1e-5
gate, grids max-rel 1e-4 as __graft_entry__.py:155-162); and the f64
oracle for torch_v2.
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import idg_tpu.parallel.mesh as jmesh
from idg_tpu.config import IDGParams as JParams
from idg_tpu.data import make_observation as jmake_observation
from idg_tpu_torch.config import IDGParams
from idg_tpu_torch.data import make_observation
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.parallel import mesh as tmesh
from idg_tpu_torch.parallel import parity
from idg_tpu_torch.parallel import sharded as tsharded
from idg_tpu_torch.parallel.distributed import distribute_observation, flat_axis_index
from idg_tpu_torch.utils.compare import check_error

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = {
    # name: (ranks, extra parity arguments, version pairs)
    "world2": (2, [], ("torch_v2/torch_v2", "cuda_v6/cuda_v7")),
    "world4": (4, ["--hier", "2", "--timeslots", "3"], ("cuda_v6/cuda_v7",)),
}
ROW_OUTPUTS = ("subgrids", "subgrids_staged", "vis", "vis_staged", "vis_replicated",
               "vis_gather")
GRID_OUTPUTS = ("grid", "grid_sharded", "grid_ranges")
SCALING_ENV = dict(GRID_SIZE="128", SUBGRID_SIZE="16", NR_STATIONS="5", NR_TIMESLOTS="4",
                   NR_TIMESTEPS_SUBGRID="16", NR_CHANNELS="8")


def _launch(nproc: int, args: list, env_extra=None) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn the three worlds at once; {name: (output dir, log)}."""
    procs = {}
    for name, (nproc, extra, pairs) in WORLDS.items():
        out = tmp_path_factory.mktemp(name)
        procs[name] = (out, _launch(nproc, [
            "idg_tpu_torch.parallel.parity", "--device", "cpu",
            "--versions", ",".join(pairs), "--out", str(out), *extra]))
    procs["scaling"] = (None, _launch(2, [
        "idg_tpu_torch", "scaling", "--mesh-sizes", "1,2", "--device", "cpu",
        "--workload", "pipeline", "--grid-method", "ranges", "--grid-sharded"], SCALING_ENV))
    done = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{name} failed:\n{log[-6000:]}"
        done[name] = (out, log)
    return done


def _params(name: str) -> IDGParams:
    nproc, extra, _ = WORLDS[name]
    return parity.small_params(nproc, 3 if "--timeslots" in extra else 4)


@functools.lru_cache(maxsize=None)
def _single(name: str, pair: str):
    params = _params(name)
    obs, _ = make_observation(params)
    return obs, parity.single_device(params, obs, *pair.split("/"), "cpu")


def _load(worlds, name: str, pair: str, output: str, rank: int) -> np.ndarray:
    out, _ = worlds[name]
    return np.load(out / f"{pair.replace('/', '-')}_{output}_rank{rank}.npy")


CASES = [(name, pair) for name, (_, _, pairs) in WORLDS.items() for pair in pairs]


@pytest.mark.parametrize("name,pair", CASES)
@pytest.mark.parametrize("output", ROW_OUTPUTS + GRID_OUTPUTS)
def test_world_matches_single_device(worlds, name, pair, output):
    """Every rank's gathered output against the port's single-device
    composition on the same inputs."""
    _, ref = _single(name, pair)
    want = {"subgrids": "subgrids", "subgrids_staged": "subgrids", "grid_sharded": "grid",
            "grid_ranges": "grid_ranges", "grid": "grid"}.get(output, "vis")
    want = ref[want].numpy()
    for rank in range(WORLDS[name][0]):
        got = _load(worlds, name, pair, output, rank)
        assert got.shape == want.shape
        if output in GRID_OUTPUTS:
            assert parity.max_rel(got, want) < 1e-6, (rank, parity.max_rel(got, want))
        else:
            res = check_error(got, want, verbose=False)
            assert res.passed, (rank, res.mean_error)


@functools.lru_cache(maxsize=None)
def _jax_sharded(name: str):
    """The JAX package's sharded results (xla_v2) on the world's problem, on
    conftest's virtual devices: make_mesh(2), or make_hier_mesh(2) (4 × 2)."""
    import jax

    from idg_tpu.parallel.distributed import make_hier_mesh
    from idg_tpu.parallel.sharded import (shard_observation, shard_observation_block_sorted,
                                          sharded_grid_to_degridder,
                                          sharded_grid_to_degridder_gather, sharded_gridder,
                                          sharded_gridder_to_grid)
    from idg_tpu.types import combine_complex, split_observation

    tp = _params(name)
    params = JParams(**dataclasses.asdict(tp))
    mesh = jmesh.make_mesh(2) if name == "world2" else make_hier_mesh(chips_per_host=2)
    obs, _ = jmake_observation(params)
    sobs, _ = shard_observation(params, split_observation(obs), mesh)
    s = params.nr_subgrids

    def c(pair):
        return combine_complex(np.asarray(pair[0]), np.asarray(pair[1]))

    grid = sharded_gridder_to_grid(params, mesh, "xla_v2")(sobs)
    block = sharded_gridder_to_grid(params, mesh, "xla_v2", grid_sharded=True)(sobs)
    sorted_sobs, _, (tstarts, lens), w = shard_observation_block_sorted(
        params, split_observation(obs), mesh)
    out = {
        "subgrids": c(sharded_gridder(params, mesh, "xla_v2")(sobs))[:s],
        "grid": c(grid),
        "grid_sharded": c(block),
        "vis_replicated": c(sharded_grid_to_degridder(params, mesh, "xla_v2")(sobs, grid))[:s],
        "vis_gather": c(sharded_grid_to_degridder_gather(params, mesh, "xla_v2")(
            sobs, block))[:s],
        "grid_ranges": c(sharded_gridder_to_grid(
            params, mesh, "xla_v2", grid_method="ranges", range_w=w)(
            sorted_sobs, tstarts, lens)),
    }
    jax.block_until_ready(grid)
    return out


JAX_OUTPUTS = ("subgrids", "grid", "grid_sharded", "vis_replicated", "vis_gather",
               "grid_ranges")


@pytest.mark.parametrize("name,pair", CASES)
@pytest.mark.parametrize("output", JAX_OUTPUTS)
def test_world_matches_jax_sharded(worlds, name, pair, output):
    """Rank 0's gathered output against the JAX package's own sharded
    pipeline (xla_v2) on the same numpy problem. The visibilities degridded
    from the gridded grid reach |vis| ≈ 1.9e4, where check_error's metric,
    which grows with the square root of the values' magnitude, puts both
    packages ~1.5e-5 from the f64 oracle; they are compared at the O(1)
    scale the 1e-5 gate is set for, divided by max |want| (the
    visibilities are linear in the grid: the scaled grid of
    tests/test_torch_grid.py)."""
    want = _jax_sharded(name)[output]
    got = _load(worlds, name, pair, output, 0)
    assert got.shape == want.shape
    if output in GRID_OUTPUTS:
        assert parity.max_rel(got, want) < 1e-4, parity.max_rel(got, want)
    else:
        scale = np.abs(want).max() if output.startswith("vis") else 1.0
        res = check_error(got / scale, want / scale, verbose=False)
        assert res.passed, res.mean_error


def test_world_matches_oracle(worlds):
    """torch_v2's sharded subgrids and visibilities against the f64 oracle
    (the visibilities, degridded from the gridded grid's subgrids, at the
    O(1) scale of test_world_matches_jax_sharded)."""
    obs, ref = _single("world2", "torch_v2/torch_v2")
    params = _params("world2")
    sub = _load(worlds, "world2", "torch_v2/torch_v2", "subgrids", 0)
    assert check_error(sub, gridder_reference(params, obs), verbose=False).passed
    vis = _load(worlds, "world2", "torch_v2/torch_v2", "vis", 1)
    golden = degridder_reference(params, obs, ref["tiles"].numpy())
    scale = np.abs(golden).max()
    assert check_error(vis / scale, golden / scale, verbose=False).passed


def test_worlds_print_their_checks(worlds):
    """parity.py's lines: every rank and check, and the padded world's mesh."""
    _, log4 = worlds["world4"]
    assert "mesh {'host': 2, 'chip': 2}, grid 128², 30 subgrids" in log4
    assert log4.count("all checks PASSED") == 4
    assert "rows 24-30 of 30" in log4            # the tail shard, 2 rows padded
    _, log2 = worlds["world2"]
    for check in ("subgrids_staged", "vis_replicated", "grid_sharded", "grid_ranges"):
        assert log2.count(f"torch_v2-torch_v2 {check}") == 2


def test_scaling_cpu_prints_its_rows(worlds):
    _, log = worlds["scaling"]
    assert "world=2 backend=gloo [cpu ranks: parity only, no time]" in log
    rows = [line.split() for line in log.splitlines()
            if line.strip().startswith(("1 ", "2 ")) and "not measured" in line]
    assert [r[0] for r in rows] == ["1", "2"]


class FakeMesh:
    """The DeviceMesh surface the host helpers read, for rank `coord` of a
    mesh of `shape`, without a world."""

    def __init__(self, shape, coord, names=("data",)):
        self.shape, self.coord, self.mesh_dim_names = shape, coord, names

    def get_coordinate(self):
        return self.coord

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]


def test_flat_axis_index_is_row_major():
    assert flat_axis_index(FakeMesh((2, 2), (1, 0), ("host", "chip"))) == 2
    assert flat_axis_index(FakeMesh((2, 2), (1, 1), ("host", "chip"))) == 3
    assert flat_axis_index(FakeMesh((2, 2), (1, 1), ("host", "chip")), ("chip",)) == 1
    assert flat_axis_index(FakeMesh((3,), None)) is None


def test_distribute_observation_pads_the_tail_shard():
    """30 subgrids over 4 ranks: rank 3 holds rows 24-29 and two zero rows
    whose time offsets are canonical, as the JAX package pads
    (idg_tpu/parallel/sharded.py:_pad_observation)."""
    from idg_tpu.parallel.sharded import _pad_observation as jpad
    from idg_tpu.types import split_observation

    params = parity.small_params(4, 3)
    obs, _ = make_observation(params)
    local, s_pad = distribute_observation(params, obs, FakeMesh((4,), (3,)))
    assert s_pad == 32 and local.uvw.shape[0] == 8
    np.testing.assert_array_equal(local.uvw[:6], obs.uvw[24:30])
    assert not local.visibilities[6:].any()
    jparams = JParams(**dataclasses.asdict(params))
    jpadded, js_pad = jpad(jparams, split_observation(jmake_observation(jparams)[0]), 4)
    assert js_pad == 32
    for f in dataclasses.fields(local.metadata):
        np.testing.assert_array_equal(getattr(local.metadata, f.name),
                                      np.asarray(getattr(jpadded.metadata, f.name))[24:32])


def test_localize_time_offset_rebases_to_the_rank_rows():
    params = parity.small_params(2)
    obs, _ = make_observation(params)
    mesh = FakeMesh((2,), (1,))
    local, _ = distribute_observation(params, obs, mesh)
    t = params.nr_timesteps_subgrid
    np.testing.assert_array_equal(local.metadata.time_offset, (20 + np.arange(20)) * t)
    rebased = tsharded._localize_time_offset(local, params, mesh)
    np.testing.assert_array_equal(rebased.metadata.time_offset, np.arange(20) * t)
    assert rebased.uvw is local.uvw


def test_padding_helpers_match_jax():
    for n, k in ((40, 8), (30, 4), (1, 3), (0, 5)):
        assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tmesh.pad_axis0(a, 5), jmesh.pad_axis0(a, 5))
    assert tmesh.pad_axis0(a, 3) is a


def test_local_rows_of_a_padded_axis():
    assert tsharded.local_rows(FakeMesh((4,), (3,)), 30) == slice(24, 30)
    assert tsharded.local_rows(FakeMesh((4,), (0,)), 30) == slice(0, 8)


def test_parallel_exports_the_jax_names():
    import idg_tpu.parallel as jpar
    import idg_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert all(callable(getattr(tpar, n)) for n in tpar.__all__)


@pytest.mark.parametrize("argv", [
    ["run", "--workload", "gridder", "--mesh", "1"],
    ["sweep", "--mesh", "1", "--versions", "cuda_v6"],
    ["scaling", "--mesh-sizes", "1"],
])
def test_mesh_commands_default_to_the_card(argv, capsys):
    """Without a card the mesh commands exit 2 before starting a world."""
    import torch.distributed as dist

    from idg_tpu_torch import cli

    assert cli.main(argv) == 2
    assert "no CUDA device is visible" in capsys.readouterr().err
    assert not dist.is_initialized()


def test_run_check_mesh_warns(capsys, monkeypatch):
    from idg_tpu_torch import cli

    monkeypatch.setattr(cli, "_check_one", lambda *a: type("R", (), {"passed": True})())
    assert cli.main(["run", "--workload", "gridder", "--mode", "check", "--mesh", "2",
                     "--device", "cpu"]) == 0
    assert cli.MESH_CHECK_WARNING in capsys.readouterr().out
