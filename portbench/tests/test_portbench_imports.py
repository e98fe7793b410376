"""Nothing the harness runs imports jax, jaxlib, flax or jn_cuclark_tpu
(top-level names compared whole: jn_cuclark_tpu_torch is the program)."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec

REHEARSAL = """
import sys
from portbench import run
from portbench.tests import tiny
out = run.run_cell(tiny.cell(sys.argv[1]), 5, 0.2, False, device="cpu")
assert out["correct"], out
print(sorted({m.split(".")[0] for m in sys.modules}))
print("forbidden:", run.forbidden_modules())
"""


@pytest.mark.parametrize("cell", ["full16x3M-se-mixed",
                                  "light16x3M-se-hits"])
def test_a_cpu_rehearsal_loads_no_forbidden_module(cell):
    p = subprocess.run([sys.executable, "-c", REHEARSAL, cell],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    top, verdict = p.stdout.strip().split("\n")[-2:]
    assert "jn_cuclark_tpu_torch" in top
    assert verdict == "forbidden: []"
    for name in ("jax", "jaxlib", "flax", "jn_cuclark_tpu"):
        assert f"'{name}'" not in top


def test_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("jn_cuclark_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jn_cuclark_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "jn_cuclark_tpu"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "full16x3M-se-mixed", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "light16x3M-se-hits", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
