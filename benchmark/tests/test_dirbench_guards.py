"""What a run refuses: no card, a checkout without the program, and a
forbidden module compared by its whole top-level name."""

import os
import shutil
import subprocess
import sys

import pytest

from dirbench import env, spec

ROOT = spec.ROOT


def _run(cwd):
    env_vars = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "age-r50-agedb.b256", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env_vars, timeout=300)


def _no_result(out: str) -> bool:
    return not any(line.strip().startswith("{") for line in out.splitlines())


def test_no_card_fails_without_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and _no_result(proc.stdout)
    assert "no CUDA device" in proc.stderr


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc.stdout)


def test_forbidden_names_compared_whole():
    assert env.forbidden_loaded(["imbalanced_regression_tpu_torch", "jaxtyping",
                                 "imbalanced_regression_tpu_torch.ops.moments"]) == []
    assert env.forbidden_loaded(["jax.numpy", "flax.linen", "imbalanced_regression_tpu.ops",
                                 "jaxlib"]) == ["flax", "imbalanced_regression_tpu", "jax",
                                                "jaxlib"]


@pytest.mark.parametrize("modules", [
    "dirbench.runner, dirbench.trace, dirbench.compare, readings",
    "reference.resnet, reference.bilstm, reference.fds, reference.optim",
])
def test_harness_and_reference_load_no_jax(modules):
    """The harness with every family, counter and reader, and the reference
    alone, in a fresh process: no JAX, no JAX package; the reference loads
    nothing of the program either."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark')!r}]
import {modules}
from dirbench import spec, env
if 'dirbench' in {modules!r}:
    for kind in ('families', 'flops', 'bytes', 'metrics'):
        for p in sorted((spec.BENCH_DIR / kind).glob('*.py')):
            spec.load_module(kind, p.stem)
    import imbalanced_regression_tpu_torch.tasks.age, imbalanced_regression_tpu_torch.tasks.stsb
bad = env.forbidden_loaded()
port = sorted(m for m in sys.modules if m.split('.')[0] == 'imbalanced_regression_tpu_torch')
print(bad, bool(port))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    bad, port = out.stdout.split("]")[0] + "]", out.stdout.split("]")[1].strip()
    assert bad == "[]"
    assert port == ("True" if "dirbench" in modules else "False")
