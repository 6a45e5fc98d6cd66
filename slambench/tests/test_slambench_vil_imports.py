"""What the VIL cell loads: never JAX or the JAX package; its reference
nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mvil_fusion_tpu"}

REHEARSAL = r"""
import sys, json
sys.path.insert(0, {root!r})
from slambench import run as R
from slambench.feeds import vil
from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.pipeline.system import VilSystem
VilSystem(SystemConfig(), enable_mapping=False, device="cpu")
print(json.dumps(R.forbidden_modules()))
"""

REFERENCE = r"""
import sys, json
sys.path.insert(0, {root!r})
import slambench.reference.vio_window, slambench.vil_stream
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_the_vil_feed_loads_no_jax():
    assert _run(REHEARSAL) == "[]"


def test_the_window_reference_loads_nothing_of_the_port():
    tops = set(json.loads(_run(REFERENCE)))
    assert not tops & (FORBIDDEN | {"mvil_fusion_torch"})
