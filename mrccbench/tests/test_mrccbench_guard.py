"""The import check compares whole top-level module names."""

import subprocess
import sys
from pathlib import Path

import pytest

from mrccbench.harness import guard

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax.linen",
                                  "mrcc_tpu", "mrcc_tpu.ops.conv_pallas"])
def test_refuses_jax_and_the_jax_package(name):
    assert guard.forbidden_modules(["numpy", name]) == [name]


@pytest.mark.parametrize("name", ["mrcc_tpu_torch", "mrcc_tpu_torch.ops",
                                  "jaxtyping", "mrcc_tpuX", "torch"])
def test_allows_the_port_and_lookalikes(name):
    assert guard.forbidden_modules([name]) == []


def test_the_reference_and_harness_import_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import mrccbench.reference.train, mrccbench.harness.core, "
            "mrccbench.work.counts, mrccbench.data.scenes; "
            "from mrccbench.harness import registry; "
            "registry.kind('train_steps'); "
            "from mrccbench.harness import guard; "
            "print(guard.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    if subprocess.run([sys.executable, "-c",
                       "import torch, sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "mrccbench/run.py", "--workload", "train.seg18-b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
