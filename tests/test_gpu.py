"""On-card checks, run through chip_smoke.py in a child process (the test
process itself stays on the CPU, so one process holds the card):

    python -m pytest -m gpu tests/test_gpu.py

Each test finds out in a fixture whether cards are present and skips
without them.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _cards() -> int:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return 0
    out = subprocess.run([smi, "-L"], capture_output=True, text=True, timeout=60)
    return out.stdout.count("GPU ") if out.returncode == 0 else 0


@pytest.fixture
def cards():
    n = _cards()
    if n == 0:
        pytest.skip("no NVIDIA GPU on this machine")
    return n


def _smoke(*args):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.gpu
def test_chip_smoke_one_card(cards):
    assert '"ok": true' in _smoke()


@pytest.mark.gpu
def test_chip_smoke_four_cards(cards):
    if cards < 4:
        pytest.skip(f"needs 4 cards, found {cards}")
    assert '"count": 4' in _smoke("--four-cards")
