"""Everything is found by name, a new cell is new files and entries
only, the names are in the allowed characters, and the import check
compares whole top-level names."""
import hashlib
import json
import re
import shutil
import sys

import pytest

from portbench.harness import core, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _tiny(cell):
    cfg = dict(registry.config(cell["config"]), n_edges=2)
    mix = dict(registry.traffic(cell["traffic"]), mission_ms=500.0)
    return cfg, mix


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"portbench/configs/{cell['config']}.json"
    assert cfg["name"] == cell["config"]
    assert registry.driver(mix["driver"]).drive
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    mod = registry.metric(metric["name"])
    assert mod.UNIT == metric["unit"]
    assert mod.BETTER == metric["better"]
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    assert mod.read({}) is None


def test_names_and_units_in_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(BENCH["configs"])])) == len(BENCH["configs"])
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = registry.metrics_for(BENCH, w["name"], False)
        layer = registry.metrics_for(BENCH, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def _digests(folder):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """A configuration, a mix and a metric added as files beside copies
    of the existing ones, listed as a new cell: it runs, reports the new
    metric, and no existing file changes."""
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(registry.HERE / sub, base / sub)
    before = _digests(registry.HERE)
    cfg = dict(registry.config("paper-28e"), name="tiny-3e", n_edges=3)
    (base / "configs" / "tiny-3e.json").write_text(json.dumps(cfg))
    mix = dict(registry.traffic("coop-replay-30s"), mission_ms=500.0,
               policy="DEMS-A")
    (base / "traffic" / "dems-a-tiny.json").write_text(json.dumps(mix))
    (base / "metrics" / "missions_run.py").write_text(
        'UNIT = "missions"\nBETTER = "higher"\nSOURCE = "host_clock"\n'
        'LAYER = "fleet entry"\nMOVES = "edge_ticks_per_s"\n\n\n'
        'def read(obs):\n    return obs.get("missions")\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="tiny-3e", source="a test",
                                 file="portbench/configs/tiny-3e.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="tiny3-dems-a", config="tiny-3e",
                                   traffic="dems-a-tiny", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "edge_ticks_per_s":
            m["workloads"].append("tiny3-dems-a")
    bench["per_layer"].append(dict(
        name="missions_run", unit="missions", better="higher",
        source="host_clock", layer="fleet entry", moves="edge_ticks_per_s",
        workloads=["tiny3-dems-a"]))
    for trace in (False, True):
        res = core.run_cell("tiny3-dems-a", 5, 0.1, trace, device="cpu",
                            bench=bench, base=base)
        assert res["correct"], res["checks"]
        want = {"edge_ticks_per_s", "setup_s"} if not trace \
            else {"missions_run"}
        assert want <= set(res["metrics"]), res["metrics"]
    assert _digests(registry.HERE) == before


@pytest.mark.parametrize("loaded,caught", [
    (("repro_torch", "repro_torch.sim.fleet"), []),
    (("reproduce", "jaxtyping", "flaxen"), []),
    (("repro",), ["repro"]),
    (("repro.sim.fleet_jax",), ["repro.sim.fleet_jax"]),
    (("jax", "jax.numpy"), ["jax", "jax.numpy"]),
    (("jaxlib.xla_client", "flax.linen"), ["flax.linen", "jaxlib.xla_client"]),
])
def test_import_check_compares_whole_top_level_names(monkeypatch, loaded,
                                                     caught):
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".", 1)[0] not in core.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    for name in loaded:
        sys.modules[name] = object()
    assert core.forbidden_modules() == caught
