"""The gridding pass of recipes/grid.py on a non-coplanar observation:
the same inputs draw for draw, then w = −v·cot δ on every track, with δ
from the mix (`declination_deg`).

  inputs    recipes/grid.py's, uvw[..., 2] replaced by
            float32(−uvw[..., 1]·cot δ); no other draw, so every other
            input is the grid mix's on the same seed, and coord_z stays 0.
  program   recipes/grid.py's build: the guard (ops/api.py:_resolve)
            escalates K1 to the Taylor rank the w range needs.
  expected  recipes/grid.py's: reference.grid_pass, whose phase carries
            w·n exactly.

The upstream draws each uv track as an ellipse centred on the origin
(inputs.uvw_tracks), the track of a baseline with no component along the
Earth's axis, for which w = −v·cot δ holds exactly (Thompson, Moran &
Swenson, Interferometry and Synthesis in Radio Astronomy, ch. 4).
"""

import numpy as np

from benchmark import catalog

GRID = catalog.load_recipe("grid")


def w_tracks(uvw: np.ndarray, declination_deg: float) -> np.ndarray:
    """f32 w = −v·cot δ of uvw's tracks, computed in float64."""
    cot = 1.0 / np.tan(np.radians(float(declination_deg)))
    return (-uvw[..., 1].astype(np.float64) * cot).astype(np.float32)


def make_inputs(problem, traffic, seed, device):
    if float(traffic["w_step"]) != problem.w_step:
        raise ValueError(f"the mix's w_step {traffic['w_step']} is not the "
                         f"configuration's {problem.w_step}")
    inp = GRID.make_inputs(problem, traffic, seed, device)
    inp.uvw[..., 2] = w_tracks(inp.uvw, traffic["declination_deg"])
    return inp


build = GRID.build
expected = GRID.expected
pass_flops = GRID.pass_flops
