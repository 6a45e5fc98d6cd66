"""What the benchmark loads: never JAX or the JAX package; the reference
nothing of the port."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

REHEARSAL = r"""
import sys, json, torch
sys.path.insert(0, {root!r})
from slambench import run as R
from slambench.feeds import mapping
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.frontend.lidar_compensator import LidarCompensator
from mvil_fusion_torch.mapping.local_mapping import LocalMapper
from mvil_fusion_torch.mapping.global_mapping import GlobalMapper
cfg = SystemConfig()
LidarCompensator(cfg, device="cpu"); LocalMapper(cfg, device="cpu")
GlobalMapper(cfg, device="cpu")
print(json.dumps(R.forbidden_modules()))
"""

REFERENCE = r"""
import sys, json
sys.path.insert(0, {root!r})
import slambench.reference.scan_judge, slambench.reference.compensate
import slambench.generator, slambench.peaks
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_rehearsal_loads_no_jax():
    assert _run(REHEARSAL) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    import json
    tops = set(json.loads(_run(REFERENCE)))
    assert not tops & {"mvil_fusion_torch", "mvil_fusion_tpu", "jax",
                       "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    from slambench import run as R
    before = R.forbidden_modules()
    try:
        sys.modules["mvil_fusion_tpu_extra"] = sys
        sys.modules["jaxfoo.bar"] = sys
        assert R.forbidden_modules() == before
        sys.modules["mvil_fusion_tpu.x"] = sys
        assert "mvil_fusion_tpu" in R.forbidden_modules()
    finally:
        sys.modules.pop("mvil_fusion_tpu.x", None)
        for k in ("mvil_fusion_tpu_extra", "jaxfoo.bar"):
            sys.modules.pop(k, None)
