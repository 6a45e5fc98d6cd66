"""The benchmark's tests import it as the package ``slambench`` from the
repository's root."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MAPPING = "indoor_slam.loop_mapping"


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
