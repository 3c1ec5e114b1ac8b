"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version and the f64 oracle at the 1e-5 gate, and the launch
counters. They skip on a host without a CUDA device.

This file imports no JAX, so it also runs on a GPU host that has none,
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from idg_tpu_torch.config import IDGParams
from idg_tpu_torch.data import make_observation, make_w_observation
from idg_tpu_torch.models.reference import degridder_reference, gridder_reference
from idg_tpu_torch.ops import cuda as kernels
from idg_tpu_torch.ops.api import _resolve
from idg_tpu_torch.ops.common import stage
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
SMALL = dict(grid_size=128, nr_stations=3, nr_timeslots=2, nr_timesteps_subgrid=16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py covers the kernels on the card)")
    return torch.device("cuda")


def _inputs(n, channels, w_scale):
    params = IDGParams(subgrid_size=n, nr_channels=channels, **SMALL)
    if w_scale is None:
        obs, sub = make_observation(params, include_subgrids=True)
    else:
        params, obs, sub = make_w_observation(params, w_scale=w_scale,
                                              include_subgrids=True)
    rank = _resolve("gridder", "cuda_v6", params, obs)[1] or 2
    return params, obs, np.ascontiguousarray(sub), rank


@pytest.mark.cuda
@pytest.mark.parametrize("n,channels,w_scale", [
    (16, 8, None), (32, 7, None), (16, 8, 1000.0), (32, 16, 1000.0),
])
def test_kernels_match_plain_and_oracle(card, n, channels, w_scale):
    params, obs, sub, rank = _inputs(n, channels, w_scale)
    stg_cpu, stg_gpu = stage(params, obs, "cpu"), stage(params, obs, card)
    sub_cpu, sub_gpu = torch.from_numpy(sub), torch.from_numpy(sub).to(card)

    got = kernels.gridder_cuda_v6(params, stg_gpu, rank)
    torch.cuda.synchronize()
    assert check_error(got, kernels.gridder_plain(params, stg_cpu, rank),
                       verbose=False).mean_error <= GATE
    assert check_error(got, gridder_reference(params, obs), verbose=False).mean_error <= GATE

    got = kernels.degridder_cuda_v7(params, stg_gpu, sub_gpu, rank)
    torch.cuda.synchronize()
    assert check_error(got, kernels.degridder_plain(params, stg_cpu, sub_cpu, rank),
                       verbose=False).mean_error <= GATE
    assert check_error(got, degridder_reference(params, obs, sub),
                       verbose=False).mean_error <= GATE


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches(card):
    params, obs, sub, rank = _inputs(16, 8, None)
    stg = stage(params, obs, card)
    kernels.reset_launch_counts()
    kernels.gridder_cuda_v6(params, stg, rank)
    kernels.gridder_cuda_v6(params, stg, rank)
    kernels.degridder_cuda_v7(params, stg, torch.from_numpy(sub).to(card), rank)
    kernels.gridder_plain(params, stg, rank)
    assert kernels.gridder_cuda_v6.launches == 2
    assert kernels.degridder_cuda_v7.launches == 1
