"""``python -m repro_torch.launch.serve`` against the JAX package's
``repro.launch.serve``: on the CPU the port's ``main`` prints the same
served / latency / tier-traffic lines as the JAX driver run in a
subprocess (the schedule, the page traffic and the migrations do not
depend on the weights), an MoE arch also the same expert-hotness line
(with the JAX driver's weights carried over, since the routing does
depend on them), and without a card the default device raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads
from repro_torch.launch import serve

cap_threads()

ROOT = Path(__file__).resolve().parents[1]


def _jax_lines(flags):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                          *flags], capture_output=True, text=True,
                         timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


@pytest.mark.parametrize("flags", [[], ["--tiers", "3", "--requests", "4",
                                        "--max-new", "10"]])
def test_serve_main_prints_what_jax_prints(flags, capsys):
    assert serve.main(["--device", "cpu", *flags]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == _jax_lines(flags)
    assert lines[0].startswith(f"served {4 if flags else 6} requests in ")
    migrations = int(lines[2].rsplit(" ", 1)[1])
    assert migrations > 0


def test_serve_main_without_memos_matches_jax(capsys):
    flags = ["--no-memos", "--requests", "3", "--max-batch", "2"]
    serve.main(["--device", "cpu", *flags])
    lines = capsys.readouterr().out.splitlines()
    assert lines == _jax_lines(flags)
    assert lines[2].endswith("migrations 0")


def test_serve_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])


@pytest.mark.parametrize("flag", ["--smoke", "--no-smoke"])
def test_serve_main_smoke_flag_parses_both_ways(flag):
    # the layout check comes before any weight is made, so the published
    # size is refused here without being built
    with pytest.raises(SystemExit, match="mamba2_1_3b: paged serving"):
        serve.main(["--device", "cpu", "--arch", "mamba2_1_3b", flag])


def test_serve_main_moe_prints_what_jax_prints(capsys, monkeypatch):
    """``--arch olmoe_1b_7b``: the served / latency / traffic lines and
    the expert-hotness line equal the JAX driver's, the port serving the
    JAX driver's own weights (``init_params(cfg, PRNGKey(0))``)."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry as jregistry
    from repro.configs import smoke as jsmoke
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    jp = JT.init_params(jsmoke(jregistry()["olmoe_1b_7b"]),
                        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    monkeypatch.setattr(
        serve.T, "init_params",
        lambda cfg, seed, device: params_from_jax(np_params, cfg,
                                                  device=device))
    flags = ["--arch", "olmoe_1b_7b"]
    assert serve.main(["--device", "cpu", *flags]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == _jax_lines(flags)
    assert len(lines) == 4 and lines[3].startswith("expert hotness: top ")
