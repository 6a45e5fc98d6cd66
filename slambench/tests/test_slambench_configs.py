"""The benchmark's configuration files: each states its source, its
assumptions and every key it changes from the system's defaults."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_states_source_assumptions_and_cuts(entry):
    from mvil_fusion_torch.config import SystemConfig
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["source"] and conf["assumed"]
    assert conf["reduced"] == entry["reduced"]
    cfg = SystemConfig.from_dict(conf["system"])
    ours = _flat(json.loads(json.dumps(cfg.to_dict())))
    default = _flat(json.loads(json.dumps(SystemConfig().to_dict())))
    changed = sorted(k for k in default if ours[k] != default[k])
    assert changed == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert key in conf["assumed"]


def test_sensor_is_the_published_c16():
    for entry in BENCH["configs"]:
        lid = json.loads((ROOT / entry["file"]).read_text())["sensor"][
            "lidar"]
        assert (lid["n_rings"], lid["n_azimuth"], lid["rate_hz"]) == \
            (16, 2000, 10.0)


def test_every_cell_has_its_files():
    names = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in names
        assert (ROOT / "slambench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (ROOT / "slambench" / "limits" / f"{w['name']}.json"
                ).exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "slambench" / "metrics" / f"{m['name']}.py").exists()
