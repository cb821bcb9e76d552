"""BENCHMARK.json and the files it names: shape, names, and what each
per-layer metric reads; the harness's imports; runs that must fail."""

import ast
import json
import pathlib
import re

import pytest

from benchmark import readers, traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
  assert set(BENCH) == KEYS
  assert 1 <= BENCH["run_seconds"] <= 51
  assert 1 <= len(BENCH["configs"]) <= 24
  assert 1 <= len(BENCH["workloads"]) <= 24
  assert 1 <= len(BENCH["end_to_end"]) <= 16
  assert 1 <= len(BENCH["per_layer"]) <= 128
  assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
  assert all(not p.startswith("/") and ".." not in p for p in
             BENCH["command"] + BENCH["paths"])


def test_a_full_check_of_24_cells_fits_its_time():
  runs = 2 + 14 * 24
  assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
  assert NAME.match(entry["name"])
  for k in ("config", "traffic"):
    if k in entry:
      assert NAME.match(entry[k])
  for k in entry.get("reduced", []):
    assert NAME.match(k)
  if "unit" in entry:
    assert UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
  for k in ("why", "layer", "source"):
    if k in entry:
      assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] \
          and "\t" not in entry[k]


def test_names_are_unique():
  for group in (BENCH["configs"], BENCH["workloads"], METRICS):
    names = [e["name"] for e in group]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
  path = ROOT / cfg["file"]
  assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
  data = json.loads(path.read_text())
  assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
  assert data["reduced"] == cfg["reduced"]
  assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
  assert (ROOT / "benchmark" / "reference"
          / f"{data['reference']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_limits(cell):
  assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
  assert cell["config"] in {c["name"] for c in BENCH["configs"]}
  traffic.load("traffic", cell["traffic"])
  limits = traffic.load("workloads", cell["name"])["limits"]
  cfg = traffic.load("configs", cell["config"])
  want = {"loss_gap", "grad_gap", "change_gap", "act_gap", "sample_gap",
          "batch_rows", "stack_pixels"}
  if cfg["flags"].get("priority_exponent", 0) > 0:
    want.add("priority_gap")
  assert set(limits) == want


def test_pairs_of_config_and_traffic_appear_once():
  pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
  assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
  e2e = {m["name"] for m in BENCH["end_to_end"]}
  assert "setup_s" in e2e and len(e2e) >= 2
  for cell in CELLS:
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_file_and_its_cells(m):
  mod = readers.load(m["name"])
  assert mod.LAYER == m["layer"] and mod.UNIT == m["unit"]
  assert mod.MOVES == m["moves"]
  moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
  assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
  assert set(m["workloads"]) <= set(CELLS)
  assert callable(mod.read)
  assert m["source"] in ("device_trace", "program_span", "program_counter",
                         "host_clock")


def test_one_layer_name_per_layer():
  by_layer = {}
  for m in BENCH["per_layer"]:
    by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
  assert all(len(v) == 1 for v in by_layer.values())


def test_end_to_end_bounds():
  for m in BENCH["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25
    assert m["source"] in ("host_clock", "device_trace")


def _imports(path: pathlib.Path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name.split(".")[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]
    elif isinstance(node, ast.Call) and getattr(
        node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"):
      for a in node.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
          yield a.value.split(".")[0]


SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
  found = set(_imports(path))
  assert not found & {"jax", "jaxlib", "flax", "dqn_zoo_tpu"}
  if "reference" in path.parts:
    assert "dqn_zoo_torch" not in found


def test_an_unknown_workload_fails():
  from benchmark import run
  assert run.main(["--workload", "no.such.cell", "--seed", "1",
                   "--seconds", "1"]) == 2


def test_a_run_without_a_card_fails_and_does_not_take_the_cpu(
    monkeypatch, capsys):
  import torch
  from benchmark import run
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1"]) == 2
  assert capsys.readouterr().out == ""
