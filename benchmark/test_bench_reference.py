"""The plain reference against a brute-force evaluation of the same
definitions at a tiny size (loops and numpy's FFT), and its TF32
rounding."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import catalog, reference

TINY = catalog.Problem(grid_size=16, subgrid_size=8, nr_stations=3, nr_timeslots=2,
                       nr_timesteps_subgrid=3, nr_channels=2, nr_correlations=4,
                       image_size=0.05, w_step=0.0)


def brute_subgrid(p, inp, s, vis):
    """c128[P, N, N]: the gridder's phasor sum, Jones A1ᴴ·P·A2 and taper of
    subgrid s, one pixel at a time."""
    n, g = p.subgrid_size, p.grid_size
    md = inp.metadata
    k = inp.wavenumbers.astype(np.float64)
    sub = np.zeros((4, n, n), complex)
    a = inp.aterms.cpu().numpy().astype(complex)
    for y in range(n):
        for x in range(n):
            l_ = (x + 0.5 - n // 2) * p.image_size / n
            m_ = (y + 0.5 - n // 2) * p.image_size / n
            tmp = l_ * l_ + m_ * m_
            n_ = tmp / (1 + math.sqrt(1 - tmp))
            u0 = (md["coord_x"][s] + n // 2 - g // 2) * 2 * math.pi / p.image_size
            v0 = (md["coord_y"][s] + n // 2 - g // 2) * 2 * math.pi / p.image_size
            po = u0 * l_ + v0 * m_
            pix = np.zeros(4, complex)
            for t in range(p.nr_timesteps_subgrid):
                u, v, w = inp.uvw[s, t].astype(np.float64)
                for c in range(p.nr_channels):
                    pix += vis[s, t, c] * np.exp(1j * (po - (u * l_ + v * m_ + w * n_) * k[c]))
            i = md["aterm_index"][s]
            a1 = a[i, md["station1"][s], y, x].reshape(2, 2)
            a2 = a[i, md["station2"][s], y, x].reshape(2, 2)
            sub[:, y, x] = (a1.conj().T @ pix.reshape(2, 2) @ a2).reshape(4) \
                * inp.spheroidal[y, x]
    return sub


GRID = catalog.load_recipe("grid")
DEGRID = catalog.load_recipe("degrid")


def with_w(inp, amplitude):
    """The inputs with w tracks a·sin(πt/T), a drawn per subgrid in
    [−amplitude, amplitude): the reference's n-term, which the traffic's
    w = 0 leaves unused."""
    s, t = inp.uvw.shape[:2]
    a = amplitude * (2.0 * np.random.default_rng(5).random(s) - 1.0)
    inp.uvw[:, :, 2] = (a[:, None] * np.sin(np.pi * (np.arange(t) + 0.5) / t)).astype(np.float32)
    return inp


@pytest.mark.parametrize("w_amplitude", [0.0, 3.0])
def test_grid_pass_against_brute_force(w_amplitude):
    p = TINY
    inp = with_w(GRID.make_inputs(p, {}, 77, "cpu"), w_amplitude)
    vis = inp.visibilities.numpy().astype(complex)
    n, g = p.subgrid_size, p.grid_size
    want = np.zeros((4, g, g), complex)
    for s in range(p.nr_subgrids):
        sub = brute_subgrid(p, inp, s, vis)
        tile = np.fft.fftshift(np.fft.ifft2(np.fft.fftshift(sub, axes=(1, 2))), axes=(1, 2))
        cy, cx = inp.metadata["coord_y"][s], inp.metadata["coord_x"][s]
        for i in range(n):
            for j in range(n):
                want[:, (cy + i) % g, (cx + j) % g] += tile[:, i, j]
    got = reference.grid_pass(p, inp).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("w_amplitude", [0.0, 3.0])
def test_degrid_pass_against_brute_force(w_amplitude):
    p = TINY
    inp = with_w(DEGRID.make_inputs(p, {}, 78, "cpu"), w_amplitude)
    grid = inp.grid.numpy().astype(complex)
    n, g = p.subgrid_size, p.grid_size
    md = inp.metadata
    k = inp.wavenumbers.astype(np.float64)
    a = inp.aterms.numpy().astype(complex)
    got = reference.degrid_pass(p, inp).numpy()
    # the recipe's expected output is the same rows in the block order
    order = DEGRID.home_block_order(md["coord_x"], md["coord_y"], g, n)
    assert np.array_equal(DEGRID.expected(p, inp).numpy(), got[order])
    for s in range(p.nr_subgrids):
        cy, cx = md["coord_y"][s], md["coord_x"][s]
        tile = np.array([[grid[:, (cy + i) % g, (cx + j) % g] for j in range(n)]
                         for i in range(n)]).transpose(2, 0, 1)
        sub = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(tile, axes=(1, 2))), axes=(1, 2))
        want = np.zeros((p.nr_timesteps_subgrid, p.nr_channels, 4), complex)
        for y in range(n):
            for x in range(n):
                l_ = (x + 0.5 - n // 2) * p.image_size / n
                m_ = (y + 0.5 - n // 2) * p.image_size / n
                tmp = l_ * l_ + m_ * m_
                n_ = tmp / (1 + math.sqrt(1 - tmp))
                po = ((cx + n // 2 - g // 2) * l_ + (cy + n // 2 - g // 2) * m_) \
                    * 2 * math.pi / p.image_size
                i_ = md["aterm_index"][s]
                a1 = a[i_, md["station1"][s], y, x].reshape(2, 2)
                a2 = a[i_, md["station2"][s], y, x].reshape(2, 2)
                pix = (a1 @ (sub[:, y, x] * inp.spheroidal[y, x]).reshape(2, 2)
                       @ a2.conj().T).reshape(4)
                for t in range(p.nr_timesteps_subgrid):
                    u, v, w = inp.uvw[s, t].astype(np.float64)
                    for c in range(p.nr_channels):
                        want[t, c] += pix * np.exp(1j * ((u * l_ + v * m_ + w * n_) * k[c] - po))
        assert np.abs(got[s] - want).max() <= 1e-12 * np.abs(want).max()


def test_dft_products_match_numpy():
    x = torch.randn(3, 4, 8, 8, dtype=torch.complex128)
    for inverse, fn in ((True, np.fft.ifft2), (False, np.fft.fft2)):
        got = reference.shifted_dft(x, inverse, reference.identity).numpy()
        want = np.fft.fftshift(fn(np.fft.fftshift(x.numpy(), axes=(-2, -1))), axes=(-2, -1))
        assert np.abs(got - want).max() < 1e-12


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + 3 * ulp / 4, 3.0],
                     dtype=torch.float64)
    assert reference.tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 3.0]
    z = torch.complex(x, -x)
    assert torch.equal(reference.tf32(z), torch.complex(reference.tf32(x), reference.tf32(-x)))
    y = torch.randn(1000, dtype=torch.float64)
    rel = ((reference.tf32(y) - y).abs() / y.abs()).max()
    assert 2.0 ** -12 < rel <= 2.0 ** -11


def test_seed_moves_every_input_and_no_size():
    p = dataclasses.replace(TINY, grid_size=64)
    a = GRID.make_inputs(p, {}, 2**40 + 1, "cpu")
    b = GRID.make_inputs(p, {}, 2**40 + 2, "cpu")
    c = GRID.make_inputs(p, {}, 2**40 + 1, "cpu")
    assert not np.array_equal(a.uvw, b.uvw)
    assert not a.uvw[..., 2].any()        # w = 0, as the upstream generator has
    assert not np.array_equal(a.metadata["coord_x"], b.metadata["coord_x"])
    assert not torch.equal(a.visibilities, b.visibilities)
    assert not torch.equal(a.aterms, b.aterms)
    assert a.visibilities.shape == b.visibilities.shape
    assert np.array_equal(a.uvw, c.uvw) and torch.equal(a.visibilities, c.visibilities)
    d = DEGRID.make_inputs(p, {}, 2**40 + 1, "cpu")
    e = DEGRID.make_inputs(p, {}, 2**40 + 2, "cpu")
    assert not torch.equal(d.grid, e.grid) and d.visibilities is None
