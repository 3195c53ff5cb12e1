"""BENCHMARK.json's cells resolve by name, and a cell added as files only is found."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench.core import cells
from port_bench.tests.conftest import ROOT

BENCH = cells.load_benchmark(ROOT)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = cells.resolve(BENCH, name, ROOT)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "train_env_steps_per_s", "peak_mem_gib"} <= e2e
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert cell.readers[m["name"]] == cells.reader_path(m["name"], ROOT)


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """A later PR adds a traffic mix, a cell and a per-layer metric by new
    files and entries alone: no file of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "port_bench/traffic/train32k.json").read_text())
    traffic.update(name="cli1k", num_envs=1024, rollout_len=64, minibatch_size=4096)
    (root / "port_bench/traffic/cli1k.json").write_text(json.dumps(traffic))
    (root / "port_bench/metrics/episodes_per_iter.train.py").write_text(
        "def read(ctx):\n    its = ctx['iterations']\n    return sum(m['episodes_finished'] for m in its) / len(its)\n")
    bench["workloads"].append({"name": "jvrc_walk.cli1k", "config": "jvrc_walk", "traffic": "cli1k", "chips": 1,
                               "why": "the command line's default batch"})
    bench["per_layer"].append({"name": "episodes_per_iter.train", "unit": "episodes", "better": "higher",
                               "source": "program_counter", "layer": "rollout", "moves": "train_env_steps_per_s",
                               "workloads": ["jvrc_walk.cli1k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve(cells.load_benchmark(root), "jvrc_walk.cli1k", root)
    assert cell.traffic["num_envs"] == 1024
    assert "episodes_per_iter.train" in [m["name"] for m in cell.per_layer]
    path = cell.readers["episodes_per_iter.train"]
    assert path == root / "port_bench/metrics/episodes_per_iter.train.py"
    ctx = {"iterations": [{"episodes_finished": 3.0}, {"episodes_finished": 5.0}]}
    assert cells.read_metric(path, ctx) == 4.0


def test_an_unknown_cell_or_reader_is_refused():
    with pytest.raises(KeyError):
        cells.resolve(BENCH, "no_such.cell", ROOT)
    with pytest.raises(FileNotFoundError):
        cells.reader_path("no_such_metric", ROOT)


def test_a_robot_and_a_floor_added_as_files_only_are_found(tmp_path):
    """A later PR adds a robot and a floor to the reference by new files
    (reference/robots/<robot>.py, reference/floors/<floor>.py) and names
    them in a new configuration: the reference's model and the counts of
    a launch follow, with no file of the harness changed."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    ref = root / "port_bench/reference"
    (ref / "robots/jvrc_light.py").write_text(
        "import dataclasses\n\nfrom ..jvrc import jvrc_spec\n\n\n"
        "def spec(**args):\n"
        "    s = jvrc_spec(**args)\n"
        "    bodies = [dataclasses.replace(b, mass=b.mass / 2) if b.name == 'PELVIS_S' else b for b in s.bodies]\n"
        "    return dataclasses.replace(s, bodies=bodies)\n")
    (ref / "floors/flat_read.py").write_text(
        "def terrain(captured, device, dtype):\n    return None\n\n\n"
        "def slot_kinds(model):\n    return ['flat'] * (4 * len(model.foot_geoms))\n\n\n"
        "def extra_bytes(model, batch):\n    return 4 * batch\n")
    config = json.loads((ROOT / "port_bench/configs/jvrc_walk.json").read_text())
    config.update(name="jvrc_light_walk", reference={"robot": "jvrc_light", "floor": "flat_read"})
    (root / "port_bench/configs/jvrc_light_walk.json").write_text(json.dumps(config))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "jvrc_light_walk", "source": "a test", "file": "port_bench/configs/jvrc_light_walk.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "jvrc_light_walk.train32k", "config": "jvrc_light_walk", "traffic": "train32k",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from pathlib import Path\n"
        "from port_bench.core import cells, launches\n"
        "from port_bench.counts import kernel_counts\n"
        "from port_bench.reference import physics\n"
        f"root = Path({str(root)!r})\n"
        "cell = cells.resolve(cells.load_benchmark(root), 'jvrc_light_walk.train32k', root)\n"
        "light, base = physics.model(cell.config['reference'], 'cpu'), physics.model({'robot': 'jvrc', 'floor': 'flat'}, 'cpu')\n"
        "ev = ['control_step_flat_kernel', 'kernel', 0.0, 1e6]\n"
        "ctx = {'cell': cell, 'counts': {'obs_size': 37, 'action_size': 12}, 'iterations': [{'episodes_finished': 0.0}],\n"
        "       'trace': {'lo': 0.0, 'hi': 1e6, 'iterations': [[ev] * 17]}}\n"
        "step = launches.launches(ctx)[1]['work']\n"
        "flat = kernel_counts.launch_work(base, physics.floor('flat'), 32768, 25, 5)\n"
        "print(json.dumps({'file': physics.robot('jvrc_light').__file__, 'mass': [float(light.body_mass.sum()), float(base.body_mass.sum())],\n"
        "                  'bytes': step['bytes'] - flat['bytes'], 'ops': step['f32'] + step['f64'] - flat['f32'] - flat['f64']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(root))
    assert got["mass"][0] < got["mass"][1]
    assert got["bytes"] == 4 * 32768 and abs(got["ops"]) < 1e-3  # same shapes: same operations
