"""K3, the folded-shift (i)DFT inside the fused gridder K1 and degridder K2
(csrc/dft.cuh), modelled on the CPU: the kernel's two real-stacked
products over all four pols in "3xtf32" (ops/precision.py:dot_mixed), with
its store of the first product's result transposed per pol, held against
the float64 DFT and against the JAX package's producer and extraction on
the same numpy inputs. A few subgrids at N = 16 and 32; the kernel itself
meets the plain versions on the card (`-m cuda tests/test_torch_cuda.py`).

Tolerances: against the float64 DFT, the model's relative RMS error
(float64 arithmetic) is at most 1.5× the float32 two-matmul plain
version's own (ops/grid.py:fft2_shift, the kernels' reference); against
the JAX compositions the reference's 1e-5 comparator (`check_error`).
"""

import numpy as np
import pytest
import torch

import idg_tpu.ops.grid as jgrid
import idg_tpu_torch.ops.grid as tgrid
from idg_tpu_torch.ops.precision import dot_mixed, split_tf32
from idg_tpu_torch.utils.compare import check_error

GATE = 1e-5
PLAIN_SLACK = 1.5   # the model's float64 error over the float32 plain version's
S = 3               # subgrids


def real_factors(n: int, inverse: bool) -> torch.Tensor:
    """Wr [(c_in, j), (c_out, k)] = [[W_re, W_im], [−W_im, W_re]] of the
    folded-shift factors, float32: the product's right operand."""
    w = tgrid.dft_shift_factors(n, inverse)
    return torch.from_numpy(np.block([[w.real, w.imag], [-w.imag, w.real]]).astype(np.float32))


def k3_model(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """c64[S, P, N, N] → out_p = Wfᵀ·x_p·Wf as the kernel takes it: pass 1
    T[(p, y), (c, k2)] = [x_re | x_im] · Wr, T stored transposed per pol as
    Tᵀ[(p, k2), (c, y)], pass 2 Tᵀ · Wr = outᵀ[(p, k2), (c, k1)], each
    product "3xtf32"."""
    s, p, n, _ = x.shape
    wr = real_factors(n, inverse)
    t = dot_mixed(torch.cat([x.real, x.imag], dim=-1), wr, "3xtf32")     # [s, p, y, (c, k2)]
    tt = t.reshape(s, p, n, 2, n).permute(0, 1, 4, 3, 2).reshape(s, p, n, 2 * n)
    out_t = dot_mixed(tt, wr, "3xtf32")                                   # [s, p, k2, (c, k1)]
    return torch.complex(out_t[..., :n], out_t[..., n:]).transpose(-1, -2)


def _inputs(n: int, seed: int = 12):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(S, 4, n, n)) + 1j * rng.normal(size=(S, 4, n, n))).astype(np.complex64)
    oyx = rng.integers(0, n, size=(S, 2)).astype(np.int32)
    return x, oyx


def _dft64(x: np.ndarray, inverse: bool) -> np.ndarray:
    """fftshift2 → (i)DFT2 → fftshift2 in float64 (the inverse with 1/N²)."""
    axes = (-2, -1)
    f = np.fft.ifft2 if inverse else np.fft.fft2
    return np.fft.fftshift(f(np.fft.fftshift(x.astype(np.complex128), axes=axes), axes=axes),
                           axes=axes)


def _rel_rms(got, want: np.ndarray) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got.astype(np.complex128) - want) / np.linalg.norm(want))


def _pair(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x.real, np.float32), np.ascontiguousarray(x.imag, np.float32)


def _complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("inverse", [True, False])
def test_k3_model_is_as_accurate_as_the_plain_version(n, inverse):
    x, _ = _inputs(n)
    want = _dft64(x, inverse)
    err_model = _rel_rms(k3_model(torch.from_numpy(x), inverse), want)
    err_plain = _rel_rms(tgrid.fft2_shift(torch.from_numpy(x), inverse), want)
    assert err_model <= PLAIN_SLACK * err_plain, (err_model, err_plain)


@pytest.mark.parametrize("n", [16, 32])
def test_k3_model_matches_jax_producer_and_extraction(n):
    """The gridder's epilogue (K3 inverse, then the roll as an index
    permutation on the store) against JAX's producer, and the degridder's
    prologue (the roll back as an index permutation on the load, then K3
    forward) against JAX's extraction tail, on the same numpy inputs."""
    x, oyx = _inputs(n)
    oy, ox = oyx[:, 0], oyx[:, 1]
    oyx_t = torch.from_numpy(oyx)
    pieces = tgrid._roll_tiles(k3_model(torch.from_numpy(x), True), oyx_t[:, 0], oyx_t[:, 1])
    want = jgrid.fft2_shift_pair(jgrid._phase_roll_fourier(_pair(x), oy, ox, shifted=True),
                                 inverse=True)
    assert check_error(pieces, _complex(want), verbose=False).mean_error <= GATE
    # the extraction's tail reads the roll from the coordinates (mod G, mod N)
    back = k3_model(tgrid._roll_tiles(torch.from_numpy(x), -oyx_t[:, 0], -oyx_t[:, 1]), False)
    want = jgrid._finish_extract(_pair(x), ox, oy, 4 * n, n, apply_fft=True)
    assert check_error(back, _complex(want), verbose=False).mean_error <= GATE


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("inverse", [True, False])
def test_split_factors_are_the_real_form_split(n, inverse):
    """ops/grid.py:dft_split_factors, the operand the kernels copy: the real
    form of the folded-shift factors, transposed, split as split_tf32."""
    hi, lo = tgrid.dft_split_factors(n, inverse)
    want_hi, want_lo = split_tf32(real_factors(n, inverse).T.contiguous())
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    w = tgrid.dft_shift_factors(n, inverse)
    assert np.allclose((hi + lo)[:n, :n].numpy().T, w.real, atol=2e-7)
    assert np.allclose((hi + lo)[n:, :n].numpy().T, w.imag, atol=2e-7)
