"""No process of a cell loads jax, jaxlib, flax or navc_tpu (compared by
whole top-level name), the reference imports nothing of the program, and
run.py refuses to run without a card or without the program."""

import os
import shutil
import subprocess
import sys

import bench_tiny as bt
from benchmark import harness

CHECK = """
import sys
sys.path[:0] = [%r, %r]
import bench_tiny as bt
from benchmark import harness
for cell in [w["name"] for w in harness.spec()["workloads"]]:
    bt.run_tiny(bt.tiny_ctx(cell, seconds=0.3))
found = harness.forbidden_modules()
assert not found, found
assert "navc_tpu_torch" in sys.modules
print("clean")
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_cell_process_loads_no_jax_nor_navc_tpu():
    code = CHECK % (os.path.dirname(os.path.abspath(__file__)), bt.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=bt.ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_forbidden_names_are_compared_whole():
    sys.modules["navc_tpu_torch_lookalike"] = sys
    sys.modules["navc_tpu.fake"] = sys
    try:
        found = harness.forbidden_modules()
        assert "navc_tpu.fake" in found and "navc_tpu_torch_lookalike" not in found
    finally:
        sys.modules.pop("navc_tpu.fake", None)
        sys.modules.pop("navc_tpu_torch_lookalike", None)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.decode; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('navc_tpu_torch', 'navc_tpu', 'jax', 'flax', 'jaxlib')]; "
            "assert not bad, bad; print('clean')" % bt.ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]
    for name in os.listdir(os.path.join(harness.BENCH, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(harness.BENCH, "reference", name)) as f:
                assert "navc_tpu" not in f.read().replace("navc_tpu_torch's", "")


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          harness.spec()["workloads"][0]["name"], "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=bt.ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(bt.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          harness.spec()["workloads"][0]["name"], "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
