"""``examples/train_tiny_lm_torch.py`` (the torch twin of
``examples/train_tiny_lm.py``) runs on the CPU: its loss drops below 0.7 of
the first step's (the example asserts it) and its checkpoint round trip
holds; without ``--device`` it needs the card."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "train_tiny_lm_torch.py")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, EXAMPLE, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_example_trains_on_cpu_and_round_trips():
    out = _run("--device", "cpu", "--steps", "40")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "on cpu" in out.stdout
    assert "checkpoint round-trip: OK" in out.stdout
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) == 5 and losses[-1] < 0.7 * losses[0]


def test_example_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    out = _run("--steps", "1")
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
