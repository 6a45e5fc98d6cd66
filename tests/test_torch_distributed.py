"""The port's mesh and multi-process bring-up
(``mvil_fusion_torch/parallel/{mesh,distributed}.py``): the mesh lays
blocks out in shard order and sums them in that order, a mesh needs a
card unless the caller names its devices, and the allreduce smoke runs in
one process over a CPU mesh and across two OS processes over gloo (each
with a 2-shard CPU mesh, 4 global shards), as tests/test_distributed.py
runs the JAX package's.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from mvil_fusion_torch.parallel import distributed
from mvil_fusion_torch.parallel import mesh as tmesh
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def test_mesh_shards_and_sums_in_shard_order():
    mesh = tmesh.make_mesh(devices=[CPU] * 4)
    x = torch.arange(8.0)
    blocks = tmesh.shard(x, mesh)
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert float(tmesh.psum(mesh, [b.sum() for b in blocks])) == 28.0
    # one partial per local shard; nothing copied on one device
    assert all(r is x for r in tmesh.replicate(x, mesh))
    with pytest.raises(ValueError, match="partials"):
        tmesh.psum(mesh, blocks[:3])
    with pytest.raises(ValueError, match="pad with masked slots"):
        tmesh.shard(torch.arange(6.0), mesh)
    with pytest.raises(ValueError, match="a mesh of 5 shards"):
        tmesh.make_mesh(5, devices=[CPU] * 4)
    assert tmesh.make_mesh(2, axis="kf", devices=[CPU] * 4) == tmesh.Mesh(
        (torch.device(CPU),) * 2, "kf")


def test_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        mesh = tmesh.make_mesh()
        assert all(d.type == "cuda" for d in mesh.devices)
        assert mesh.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmesh.make_mesh()


def test_each_of_several_processes_takes_its_own_card():
    cuda = torch.device
    assert distributed.local_devices(None, 4, 3, n_cards=2) == [
        cuda("cuda", 1)]
    assert distributed.local_devices(None, 2, 0, 2, n_cards=2) == [
        cuda("cuda", 0)] * 2
    assert distributed.local_devices(CPU, 2, 1) == [cuda(CPU)] * 2
    assert distributed.local_devices(None, 1, 0, n_cards=2) is None


def test_smoke_single_process():
    assert distributed.smoke(devices=[CPU] * 8) == 8
    assert distributed.smoke(4, devices=[CPU] * 8) == 4


def run_two_processes(argv):
    """`argv` + ["--coordinator=…", "--num-processes=2",
    "--process-id=k"] in two OS processes on a free local port: their
    outputs, after both exited 0 within 120 s."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, *argv, f"--coordinator=localhost:{port}",
         "--num-processes=2", f"--process-id={pid}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the 2-process run timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
    return outs


def test_two_process_allreduce():
    outs = run_two_processes(["-m", "mvil_fusion_torch.parallel.distributed",
                              "--device=cpu", "--local-shards=2"])
    for out in outs:
        assert "4 global shards (2 processes, backend gloo)" in out, out
        assert "allreduce smoke over 4 shards OK" in out, out


SOLVE_ACROSS = """
import argparse, torch
import chip_smoke
from mvil_fusion_torch.mapping import pose_graph as pg
from mvil_fusion_torch.parallel import distributed, mesh as M
from mvil_fusion_torch.parallel.sharded_pose_graph import solve_cg_sharded
ap = argparse.ArgumentParser()
for a in ("--coordinator", "--num-processes", "--process-id"):
    ap.add_argument(a)
args = ap.parse_args()
distributed.init(args.coordinator, int(args.num_processes),
                 int(args.process_id), device="cpu")
torch.set_num_threads(1)
arrays, _ = chip_smoke.make_helix_graph(n=64, e=256)
g = pg.graph_from_numpy(arrays, device="cpu")
mesh = M.make_mesh(devices=["cpu"] * 2, group=torch.distributed.group.WORLD)
out = solve_cg_sharded(g, mesh, iters=3, cg_iters=16)
ref = pg.solve_cg(g, iters=3, cg_iters=16)
print("shards", mesh.size, "offset", mesh.offset, "gap",
      float((out.p - ref.p).abs().max()), flush=True)
torch.distributed.destroy_process_group()
"""


def test_sharded_solve_across_two_processes():
    """A mesh of 2 processes × 2 shards: each process solves with its half
    of the edges, and the mesh's sum joins them through gloo; both get the
    unsharded solve within 1e-5."""
    outs = run_two_processes(["-c", SOLVE_ACROSS])
    offsets = []
    for out in outs:
        words = out.split()
        at = words.index("shards")
        assert words[at + 1] == "4", out
        offsets.append(int(words[at + 3]))
        assert float(words[at + 5]) < 1e-5, out
    assert sorted(offsets) == [0, 2]


SOLVE_BA_ACROSS = """
import argparse, torch
import chip_smoke
from mvil_fusion_torch.estimator import ba
from mvil_fusion_torch.parallel import distributed, mesh as M
from mvil_fusion_torch.parallel import sharded_ba as sba
ap = argparse.ArgumentParser()
for a in ("--coordinator", "--num-processes", "--process-id"):
    ap.add_argument(a)
args = ap.parse_args()
distributed.init(args.coordinator, int(args.num_processes),
                 int(args.process_id), device="cpu")
torch.set_num_threads(1)
win = chip_smoke.VioWindow(torch, chip_smoke.vio_world(800),
                           chip_smoke.VIO_T0, 64, "cpu", seed=3)
prob = win.problem()
mesh = M.make_mesh(devices=["cpu"] * 2, group=torch.distributed.group.WORLD)
solve = sba.make_sharded_solver(mesh, win.focal, iters=4)
out = solve(*sba.shard_problem(mesh, win.start, prob))
ref = ba.solve(win.start, prob, win.focal, iters=4)
print("shards", mesh.size, "offset", mesh.offset, "gap",
      float((out.state.pose.p - ref.state.p).abs().max()), "cost0",
      abs(float(out.cost0) / float(ref.cost0) - 1.0), "accepted",
      int(out.n_accepted), int(ref.n_accepted), flush=True)
torch.distributed.destroy_process_group()
"""


def test_sharded_ba_across_two_processes():
    """A mesh of 2 processes × 2 shards: each process solves with its half
    of the landmarks, only the first process's first shard carries the
    dense rows, and the mesh's sum joins them through gloo; both get the
    unsharded solve within tests/test_sharded_ba.py's gates (positions
    2e-3 m, cost0 1e-4 relative, the same accepted count)."""
    outs = run_two_processes(["-c", SOLVE_BA_ACROSS])
    offsets = []
    for out in outs:
        words = out.split()
        at = words.index("shards")
        assert words[at + 1] == "4", out
        offsets.append(int(words[at + 3]))
        assert float(words[at + 5]) < 2e-3, out
        assert float(words[at + 7]) < 1e-4, out
        assert words[at + 9] == words[at + 10], out
    assert sorted(offsets) == [0, 2]
