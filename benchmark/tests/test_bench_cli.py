"""``run.py`` on a machine without a card: no result, a non-zero exit."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("cell", ["pnet-train-b64", "ae-train-b256"])
def test_run_fails_without_a_card(cell):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this test is for a machine without one")
    out = subprocess.run([sys.executable, os.path.join("benchmark", "run.py"), "--workload", cell,
                          "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
