"""``chip_smoke.kink_flips``: which ReLU sign differences between the card
and the exact (float64) step count as float32 landing on the other side of
a kink, and which are left to the step check as faults.

A sign difference is a kink crossing only where both the float64 input
and the card's distance from it lie within ``F32_FACTOR`` times the
reach of the float32 witness over that input's own row; a row with large
rounding errors does not widen another row's reach.

``chip_smoke.write_unit_test_data``, the ``unit_test`` generator without
scikit-learn, against ``tests/synthetic.py``: the same cells, positions and
atom types from the same seed, the same file format, and the same targets
given the same ``out_x`` (the nearest-neighbour ties on the lattice may
fall otherwise, so ``out_x`` itself is held to be a mean of each atom's
type and one of its nearest atoms' types).
"""

import os

import numpy as np
import torch

import chip_smoke as cs
from synthetic import deterministic_graph_data


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


def _read(path):
    with open(path) as f:
        lines = f.read().split("\n")
    rows = np.asarray([[float(v) for v in line.split("\t")] for line in lines[1:]])
    return lines, rows


def pytest_unit_test_generator_matches_the_synthetic_one(tmp_path):
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    cells = ((1, 3), (1, 3), (1, 2)), ((3, 5), (3, 5), (3, 5))
    for i, cell in enumerate(cells):
        cs.write_unit_test_data(os.path.join(mine, str(i)), 12, cells=cell)
        deterministic_graph_data(os.path.join(ref, str(i)), number_configurations=12,
                                 unit_cell_x_range=cell[0], unit_cell_y_range=cell[1],
                                 unit_cell_z_range=cell[2])
        for c in range(12):
            name = f"output{c}.txt"
            lines, rows = _read(os.path.join(mine, str(i), name))
            want_lines, want = _read(os.path.join(ref, str(i), name))
            assert len(lines) == len(want_lines) and len(lines[0].split("\t")) == 2
            np.testing.assert_array_equal(rows[:, :5], want[:, :5])  # type, index, x y z
            # the targets of the reference's out_x, by this generator's formulas
            feature, positions, out_x = want[:, :1], want[:, 2:5], want[:, 5:6]
            assert cs.unit_test_text(feature, positions, out_x) == "\n".join(want_lines)
            # this generator's out_x: the mean of the atom's type and a nearest atom's
            d = np.linalg.norm(positions[:, None] - positions[None], axis=-1)
            np.fill_diagonal(d, np.inf)
            nearest = np.isclose(d, d.min(axis=1, keepdims=True))
            pairs = (feature[:, 0][:, None] + feature[:, 0][None]) / 2
            assert all(rows[a, 5] in pairs[a][nearest[a]] for a in range(len(rows)))
            assert cs.unit_test_text(feature, positions, rows[:, 5:6]) == "\n".join(lines)
