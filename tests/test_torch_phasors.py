"""K1's phasor block on the CPU: the float32 model of sincosf's fast path
(ops/cuda/phasors.py:sincosf_straight_plain) against csrc/common.cuh's
constants and against float64 sin and cos, the quadrant from the rounding
sum against rint, the straight path's flag at its edges, the check's plain
version (ops/cuda/phasors.py:phasor_check) and that K1's formation takes
the block. Bit-for-bit equality with CUDA's sincosf is the card's test
(-m cuda tests/test_torch_cuda.py -k phasor)."""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from idg_tpu_torch.ops.cuda import phasors

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "idg_tpu_torch" / "csrc"


def _straight_source() -> str:
    text = (CSRC / "common.cuh").read_text()
    return text[text.index("bool sincosf_straight("):text.index("// sincosf of kN phases")]


def _hex_floats(text: str) -> list:
    return [float.fromhex(h) for h in re.findall(r"(-?0x[0-9a-f.]+p[-+]\d+)f", text)]


def test_model_constants_are_the_kernels():
    """The model's constants, in the order they appear in
    common.cuh:sincosf_straight (2/π, π/2's three parts, the cosine's and
    the sine's coefficients), and the fast path's bound."""
    want = [phasors.TWO_OVER_PI, *phasors.HALF_PI, *phasors.COS_POLY, *phasors.SIN_POLY]
    assert _hex_floats(_straight_source()) == want
    assert all(np.float32(v) == v for v in want)
    text = (CSRC / "common.cuh").read_text()
    assert re.search(r"constexpr float kSincosfFastMax = ([0-9.]+)f;", text).group(1) == "105615.0"
    assert phasors.FAST_MAX == 105615.0


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-100.0, 100.0), (-2e3, 2e3),
                                   (-1.05e5, 1.05e5)])
def test_model_holds_float64_sin_and_cos(lo, hi):
    """On 2^20 float32 arguments in [lo, hi] (the grid cells' phases reach
    ~1.6e3 rad, ska1-low's ~1.3e4) the straight path is within 1e-7 of
    float64 sin and cos of the float32 argument, unflagged."""
    x = torch.linspace(lo, hi, 2**20, dtype=torch.float32)
    s, c, slow = phasors.sincosf_straight_plain(x)
    assert not slow.any()
    x64 = x.double()
    assert (s.double() - torch.sin(x64)).abs().max() < 1e-7
    assert (c.double() - torch.cos(x64)).abs().max() < 1e-7
    assert (s.double() ** 2 + c.double() ** 2 - 1).abs().max() < 4e-7


def test_model_quadrant_is_rint():
    """The rounding sum x·2/π + 1.5·2^23 gives rint (ties to even) of the
    float32 product, as sincosf's cvt.rni does, for |x·2/π| < 2^22: here at
    and around every half-integer product up to 2^16 and at random ones."""
    half = torch.arange(-2**16, 2**16, dtype=torch.float64) + 0.5
    p = torch.cat([half.float(), torch.nextafter(half.float(), torch.tensor(0.0)),
                   torch.nextafter(half.float(), torch.tensor(float("inf"))),
                   torch.empty(2**18).uniform_(-4e6, 4e6,
                                               generator=torch.Generator().manual_seed(3))])
    t = p + torch.tensor(phasors.ROUND_INT, dtype=torch.float32)
    q = t - phasors.ROUND_INT
    assert torch.equal(q, torch.round(p))    # torch.round: half to even
    assert torch.equal(t.view(torch.int32) & 3, torch.round(p).long().remainder(4).int())


def test_model_signs_and_edges():
    """sin(±0) = ±0 and cos(±0) = 1, subnormals pass through; the flag is
    set from 105,615 (and its negative) up, on ±inf and NaN, and clear on
    the float below 105,615."""
    tiny = float(np.float32(1e-40))
    below = float(np.nextafter(np.float32(105615.0), np.float32(0.0)))
    x = torch.tensor([0.0, -0.0, tiny, -tiny, below, -below, 105615.0, -105615.0,
                      float(np.nextafter(np.float32(105615.0), np.float32(2e5))), 1e6,
                      float("inf"), float("-inf"), float("nan")])
    s, c, slow = phasors.sincosf_straight_plain(x)
    assert s[:4].view(torch.int32).tolist() == x[:4].view(torch.int32).tolist()
    assert c[:4].tolist() == [1.0] * 4
    assert slow.tolist() == [False] * 6 + [True] * 7


@pytest.mark.parametrize("multiple", [1, 2, 3, 7, 64, 1001, 40000])
def test_model_near_multiples_of_half_pi(multiple):
    """At k·π/2 ± a few ulps, where the reduction cancels most bits, the
    straight path keeps sin and cos within 1e-7 of float64's."""
    x0 = np.float32(multiple * math.pi / 2)
    x = [x0]
    for _ in range(4):
        x = [np.nextafter(x[0], np.float32(0)), *x, np.nextafter(x[-1], np.float32(2e5))]
    x = torch.tensor(np.array(x + [-v for v in x], np.float32))
    s, c, slow = phasors.sincosf_straight_plain(x)
    x64 = x.double()
    assert not slow.any()
    assert (s.double() - torch.sin(x64)).abs().max() < 1e-7
    assert (c.double() - torch.cos(x64)).abs().max() < 1e-7


def test_check_plain_version_counts():
    """The check's plain version on the CPU: got within 1.2e-7 of torch's
    float32 sin and cos (which are not CUDA's), flagged arguments counted,
    and the 128-argument blocks that hold one counted as fallbacks; on bit
    patterns the same counts as on their values."""
    x = torch.cat([torch.linspace(-1e5, 1e5, 1000), torch.tensor([2e5, float("nan")]),
                   torch.linspace(-3.0, 3.0, 600)])
    got, want, counts = phasors.phasor_check(x)
    assert got.shape == want.shape == (x.numel(), 2)
    assert (got - want)[:1000].abs().max() < 1.2e-7 and (got - want)[1002:].abs().max() < 1.2e-7
    assert torch.equal(got[1000:1002].view(torch.int32), want[1000:1002].view(torch.int32))
    assert counts["flagged"] == 2 and counts["fallbacks"] == 1
    first = int(np.float32(105600.0).view(np.uint32))
    got_b, _, by_bits = phasors.phasor_check(first=first, count=3000)
    values = torch.from_numpy(np.arange(first, first + 3000, dtype=np.uint32).view(np.float32))
    got_v, _, by_values = phasors.phasor_check(values.clone())
    assert by_bits == by_values and torch.equal(got_b.view(torch.int32), got_v.view(torch.int32))
    assert by_bits["flagged"] == int((values.abs() >= 105615.0).sum()) > 0


def test_check_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="contiguous 1-D float32"):
        phasors.phasor_check(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="out of range"):
        phasors.phasor_check(first=0, count=0)
    with pytest.raises(ValueError, match="out of range"):
        phasors.phasor_check(first=2**32, count=1)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        phasors.phasor_check(torch.zeros(4, device="meta"))


def test_k1_forms_its_phasors_with_the_block_and_the_others_keep_sincosf():
    """K1's formation evaluates its 8 phasors a tile with two
    sincosf_block calls (Φx's four, Φy's four) and calls sincosf nowhere
    else; K2 keeps its sincosf, and no other kernel takes the block."""
    def code(name):
        return re.sub(r"//[^\n]*", "", (CSRC / name).read_text())

    gridder = code("gridder.cu")
    assert gridder.count("sincosf_block(") == 2
    assert not re.search(r"\bsincosf\(", gridder)
    assert re.search(r"\bsincosf\(", code("degridder.cu"))
    for src in CSRC.glob("*.cu"):
        if src.name not in ("gridder.cu", "phasor_check.cu"):
            assert "sincosf_block" not in code(src.name), src.name
