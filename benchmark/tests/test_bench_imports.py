"""Nothing the benchmark runs imports JAX or the JAX package, the plain
reference imports nothing of the program, and ``run.py`` prints no result
where it cannot measure."""
import ast
import json
import os
import shutil
import subprocess
import sys

from harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "audio_diffusion_tpu"}


def imported(path):
    """Top-level names of every module a file imports (the part before the
    first dot, whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_jax_anywhere_in_the_benchmark():
    for path in core.BENCH_DIR.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (core.BENCH_DIR / "reference").glob("*.py"):
        names = imported(path)
        assert "audio_diffusion_torch" not in names, path
        assert not names & {"harness", "drivers", "metrics", "counts"}, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "audio_diffusion_tpu_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_modules() == ["jax.numpy"]


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "uncond-sample-b1",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        json.loads(last)
        return False
    except ValueError:
        return True


def test_without_a_card_no_result():
    proc = _run(core.ROOT)
    assert proc.returncode != 0 and _no_result(proc)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
