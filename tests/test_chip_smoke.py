"""chip_smoke.py's logic away from the card: the four-card phase on four
virtual CPU devices (tiny blocks), and the refusal to run without a
GPU or outside a checkout."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_four_cards_phase_on_virtual_devices(capsys):
    chip_smoke.four_cards(jax.devices("cpu")[:4], fs=1e6, k_sf=2,
                          mc_receivers=3, mc_blocks=4, block_samples=4096,
                          max_blocks=3)
    out = capsys.readouterr().out
    assert "groups [3, 6] blocks, identical to one device: [True, True]" in out
    assert "3 x 4 blocks over the mesh: identical to one device: True" in out


def test_refuses_without_gpu_or_checkout(tmp_path):
    """Without a card (this suite's CPU) or copied out of the checkout,
    the script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        r = subprocess.run([sys.executable, script, "--four-cards"],
                           cwd=cwd, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
