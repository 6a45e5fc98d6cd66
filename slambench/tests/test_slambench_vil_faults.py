"""The VIL cell's comparison tells a sound run from the faults.

One run with ``read_faults`` judges the program's own answers and, on the
same windows, the answers of faulty programs: the solve skipped (the
state it started from) and the window solve in bfloat16 (the reference's
own LM in that precision, at the program's iteration count), each judged
by the float64 reference with frame 0's position and yaw held (the
median over the judged windows); and the frame gaps that a skipped solve
leaves in the published poses (their median).  The sound numbers lie
within the cell's limits and each fault's above its limit.  A second run
cuts the program's own Levenberg-Marquardt to one iteration a frame and
reads not correct.

Read and not held to a limit: the LM cut to one iteration on a single
window (it starts from a window that eight iterations a frame have
refined, so it lands among the sound runs), and the LiDAR rows dropped
(the published estimator adds a scan-to-scan row only where the VIO and
VGICP disagree by more than 10 cm, ``lidar_frontend``'s mode 3, so in a
window without one the fault changes nothing; ``icp_rows`` counts the
rows of each judged window).

On the CPU the sweeps are cut to 16 × 500, the window to 20 s, and 3
windows are judged; set-up runs to 40 solves, not 10: a CPU window holds
~15 frames, which right after initialization would all lie in the
estimator's convergence transient (frame gaps of 3–9 cm on seed
4017000101 at 10 solves), where the card's window of 30–60 frames takes
that transient into its medians.  On a card (marked ``cuda``, skipped
without one) the runs are the cell's own.
"""

import pytest
import torch
from conftest import bench

from slambench import run as R

VIL = "vil_odom.feature_replay"
FAULTS = ("fault_unchanged_median_m", "control_bfloat16_median_m")
CARD = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="needs a card")


def _small(conf, traffic, limits):
    conf["sensor"]["lidar"]["n_azimuth"] = 500
    traffic["stream_s"] = 60.0
    traffic["warm"] = dict(traffic["warm"], min_solves=40)
    traffic["judge"] = {"windows": 3, "sweep_pairs": 3}


def _one_iteration(conf):
    e = conf["system"]["estimator"]
    e["max_solver_iters"] = e["min_solver_iters"] = 1


def _faults_read(device, seed, seconds, shrink):
    line, out = R.run_cell(bench(), VIL, seed, seconds, 0, device, 0.0,
                           overrides=shrink, read_faults=True)
    info, limits = out["info"], {n: lim for n, _, lim in out["compared"]}
    assert line["correct"], line["compared"]
    for name in FAULTS:
        assert info[name] > limits["window_move_median_m"], (name,
                                                             info[name])
    assert info["fault_unchanged_frame_gap_median_m"] > \
        limits["frame_gap_median_m"]
    for name in ("fault_one_iteration_median_m", "fault_no_lidar_median_m",
                 "icp_rows"):
        assert name in info


def _one_iteration_reads_not_correct(device, seed, seconds, shrink):
    def cut(conf, traffic, limits):
        if shrink is not None:
            shrink(conf, traffic, limits)
        _one_iteration(conf)
    line, _ = R.run_cell(bench(), VIL, seed, seconds, 0, device, 0.0,
                         overrides=cut)
    assert not line["correct"], line["compared"]


def test_the_faults_read_not_correct_on_the_cpu():
    torch.set_num_threads(2)
    _faults_read(torch.device("cpu"), 4017000101, 20.0, _small)


def test_one_iteration_a_frame_reads_not_correct_on_the_cpu():
    torch.set_num_threads(2)
    _one_iteration_reads_not_correct(torch.device("cpu"), 4017000103, 20.0,
                                     _small)


@pytest.mark.cuda
@CARD
def test_the_faults_read_not_correct_at_the_cells_size():
    _faults_read(torch.device("cuda", 0), 4017000102, 51.0, None)


@pytest.mark.cuda
@CARD
def test_one_iteration_a_frame_reads_not_correct_at_the_cells_size():
    _one_iteration_reads_not_correct(torch.device("cuda", 0), 4017000104,
                                     51.0, None)
