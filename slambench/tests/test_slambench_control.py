"""The control of the cell's comparison (the reference in the program's
place, in bfloat16: the compensator and the deskew of the sweeps a run
judges) comes out not correct.

On the CPU at the published sweep size, on the orbit shrunk to 4 s a
lap so that set-up casts fewer sweeps.  On a card (marked ``cuda``,
skipped without one): at the cell's own size, as
``slambench/control.py`` runs it there.
"""

import math

import pytest
import torch
from conftest import MAPPING, bench

from slambench import control


def _not_correct(out):
    return not all(math.isfinite(v) and v <= lim for _, v, lim in out)


def _small_orbit(conf, traffic, limits):
    traffic["trajectory"].update(period_s=4.0, p_amp=[1.2, 0.6, 0.2])
    traffic["warm"] = {"min_sweeps": 40, "max_sweeps": 40}


def test_mapping_control_fails_on_the_cpu():
    torch.set_num_threads(4)
    out = control.control_readings(bench(), MAPPING, 20261019,
                                   torch.device("cpu"), 40, _small_orbit)
    assert _not_correct(out), out


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    for seed in (20261020, 20261021, 20261022):
        out = control.control_readings(bench(), MAPPING, seed,
                                       torch.device("cuda"), 700)
        assert _not_correct(out), (seed, out)
