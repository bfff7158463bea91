"""The port's twins of ``examples/quickstart.py`` and
``examples/serve_paged.py`` (``repro_torch.launch.quickstart`` and
``.serve_paged``) print what the JAX examples print, line for line, on
the CPU: the memos core's placement table (it does not depend on any
weights) and the paged engine's served tokens, KV traffic, memos passes
and pool occupancy (with the JAX example's own weights carried over,
since the greedy tokens depend on them).  Without a card the default
device raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads
from repro_torch.launch import quickstart, serve_paged

cap_threads()

ROOT = Path(__file__).resolve().parents[1]


def _jax_lines(example):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / example)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_quickstart_prints_what_jax_prints(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == _jax_lines("quickstart.py")
    assert lines[-1] == "all page contents bit-exact after migrations ✓"
    assert "  pages 16..23 tier: [0, 0, 0, 0, 0, 0, 0, 0] (0=FAST)" in lines


def test_serve_paged_prints_what_jax_prints(capsys, monkeypatch):
    jax = pytest.importorskip("jax")
    from repro.configs import registry as jregistry
    from repro.configs import smoke as jsmoke
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    jp = jax.tree.map(np.asarray, JT.init_params(
        jsmoke(jregistry()["qwen3_4b"]), jax.random.PRNGKey(0)))
    monkeypatch.setattr(
        serve_paged.T, "init_params",
        lambda cfg, seed, device: params_from_jax(jp, cfg, device=device))
    assert serve_paged.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == _jax_lines("serve_paged.py")
    assert lines[0].startswith("served 6 requests in ")
    migrations = int(lines[-2].rsplit(" ", 1)[1])
    assert migrations > 0


@pytest.mark.parametrize("twin", [quickstart, serve_paged])
def test_twin_raises_without_a_card(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.main([])
