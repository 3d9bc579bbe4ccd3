"""``chip_smoke.kink_flips``: which ReLU sign differences between the card
and the exact (float64) step count as float32 landing on the other side of
a kink, and which are left to the step check as faults.

A sign difference is a kink crossing only where both the float64 input
and the card's distance from it lie within ``F32_FACTOR`` times the
reach of the float32 witness over that input's own row; a row with large
rounding errors does not widen another row's reach.
"""

import torch

import chip_smoke as cs


def _calls():
    """One call of 3 rows x 4 features: the float64 inputs, the float32
    witness (off by 1e-6 in row 0, by 1.0 in row 2) and the card's
    inputs (the witness's values, to be edited)."""
    z64 = torch.tensor([[1e-7, 0.5, -0.2, 0.3],
                        [2e-3, -0.4, 0.1, 0.7],
                        [0.6, -0.9, 0.8, 0.3]], dtype=torch.float64)
    z32 = z64.clone()
    z32[0, 3] += 1e-6
    z32[2, 0] += 1.0
    return z32, z64, z32.clone()


def pytest_kink_within_the_rows_reach_is_flipped():
    z32, z64, card = _calls()
    card[0, 0] = -5e-7  # the other side of the kink, within 4 x 1e-6 of it
    got = cs.kink_flips([z32], [z64], [card])
    assert got["count"] == 1 and got["beyond"] == 0
    assert torch.equal(got["masks"][0], torch.tensor([[True, False, False, False],
                                                      [False] * 4, [False] * 4]))
    site, value, reach = got["flipped"][0]
    assert (site, value) == (0, 1e-7) and abs(reach - 1e-6) < 1e-12
    assert got["nearest"][0] == 0 and got["nearest"][1] == 1e-7


def pytest_planted_sign_errors_beyond_reach_are_refused():
    z32, z64, card = _calls()
    card[0, 1] = -0.5  # a planted sign error: float64 input 0.5, reach 1e-6
    card[0, 0] = -0.3  # float64 input within reach, but the card far from it
    # row 1 has no witness error: a large error in row 2 (1.0) does not
    # make its 2e-3 a kink
    card[1, 0] = -2e-3
    got = cs.kink_flips([z32], [z64], [card])
    assert got["count"] == 0 and got["masks"] == {} and got["beyond"] == 3


def pytest_only_a_few_kink_crossings_are_held_on_the_cards_side():
    z32, z64, card = _calls()
    z64 = z64.repeat(cs.KINK_FLIPS_MAX + 1, 1)
    z32 = z32.repeat(cs.KINK_FLIPS_MAX + 1, 1)
    card = z32.clone()
    card[0::3, 0] = -5e-7  # the same crossing in every copy of row 0
    got = cs.kink_flips([z32], [z64], [card])
    assert got["count"] == cs.KINK_FLIPS_MAX + 1 > cs.KINK_FLIPS_MAX
