"""The harness finds every configuration, traffic mix, driver and per-layer
reader by the name in ``BENCHMARK.json``, and a cell added as new files and
entries needs no edit of a file that is there."""
import json
import shutil

from harness import core
from tiny import bench


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = core.Cell.find(w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(cell.driver().setup)
        readers = cell.readers()
        assert readers and all(callable(r.read) for r in readers.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2


def test_config_files_hold_the_configs():
    b = bench()
    for c in b["configs"]:
        data = json.loads((core.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_added_cell_needs_no_edit(tmp_path):
    """A copy of the benchmark with one more traffic mix, one more reader
    and their entries: the harness finds them, and every file that was
    there is unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    traffic = json.loads((root / "benchmark/traffic/uncond-sample-b1.json")
                         .read_text())
    traffic["num_steps"] = 25
    (root / "benchmark/traffic/uncond-sample-25.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/dummy_ms.sample.py").write_text(
        "def read(run):\n    return 1.0\n")
    b["workloads"].append(dict(name="uncond-sample-25",
                               config="unconditional-48k",
                               traffic="uncond-sample-25", chips=1,
                               why="a 25-step variant"))
    b["per_layer"].append(dict(name="dummy_ms.sample", unit="ms",
                               better="lower", source="host_clock",
                               layer="net", moves="sample_ms_per_step",
                               workloads=["uncond-sample-25"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = core.Cell.find("uncond-sample-25", root / "BENCHMARK.json",
                          root / "benchmark")
    assert cell.traffic["num_steps"] == 25
    assert cell.driver().__file__.startswith(str(root))
    readers = cell.readers()
    assert readers["dummy_ms.sample"].read(None) == 1.0
    assert set(readers) == {"dummy_ms.sample"}
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
