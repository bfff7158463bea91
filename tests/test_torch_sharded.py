"""The port's multi-device training against the JAX package, on the CPU:
8 gloo processes form a (2, 4) ``("data", "model")`` DeviceMesh, once for
the whole file (``tests/helpers/torch_sharded_gate.py``).

  * ``moe_apply``'s expert-parallel branch (smoke olmoe at capacity
    1.25, where rows are dropped) and tensor-parallel branch (smoke
    mixtral with 2 experts, d_ff split 4 ways) against JAX's sharded
    ``moe_apply`` on 8 placeholder XLA devices: ``idx`` and the counts
    exactly, ``y`` within 1e-5/1e-4;
  * the sharded train step for the seven archs and modes of
    ``tests/helpers/sharded_gate.py`` against the JAX package's unsharded
    step on the same weights and batch, with C2's tolerances: the loss
    within 1e-5, the parameters within 2e-5 where |g| >= 1e-6 (from the
    first moment), the first moments within 1e-4 of each leaf's largest,
    the expert counts exactly;
  * ``Checkpointer.restore(..., shardings=)`` onto a smaller mesh after
    ``plan_elastic_remesh`` gives back the same whole tensors.

Each process runs one torch thread; the rendezvous is a file under the
test's temporary directory, so parallel workers do not collide."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers import torch_sharded_gate as gate
from helpers.torch_parity import assert_close, assert_same
from repro_torch import tree
from repro_torch.convert import params_from_jax

LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
GRAD_FLOOR = 1e-6
MOMENT_REL = 1e-4     # C2: each gradient leaf within 1e-4 of its largest
LR = 3e-4
WORLD = gate.MESH[0] * gate.MESH[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (a subprocess) and the port's 8 ranks, run side
    by side."""
    d = tmp_path_factory.mktemp("torch_sharded")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    jax_out, torch_out = d / "jax.pkl", d / "torch.pkl"
    proc = subprocess.Popen([sys.executable, gate.__file__, "jax",
                             str(jax_out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(gate.torch_ranks, args=(WORLD, f"file://{d}/rdv",
                                         str(torch_out), str(d / "ckpt")),
             nprocs=WORLD)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    with open(torch_out, "rb") as f:
        got = pickle.load(f)
    return got, want


@pytest.mark.parametrize("name", ["ep", "tp"])
def test_moe_apply_matches_jax_sharded(runs, name):
    got, want = runs[0]["moe"][name], runs[1]["moe"][name]
    assert_same(got["idx"], want["idx"].reshape(got["idx"].shape))
    assert_same(got["counts"], want["counts"])
    assert got["counts"].dtype == np.int32
    assert_close(got["probs"], want["probs"].reshape(got["probs"].shape))
    assert_close(got["y"], want["y"])


def test_ep_capacity_drops_rows():
    """At capacity 1.25 some slots of the EP case fall past a shard's
    capacity (their token sums omit them), at 8.0 none do; JAX's rule."""
    from repro_torch.models import moe
    cfg = gate.port_cfg(*gate.MOE_CASES["ep"])
    x, w = gate.moe_inputs(cfg)
    n_ep, t_local = gate.MESH[1], gate.B * gate.S // gate.MESH[0]
    p = {k: torch.from_numpy(v) for k, v in w.items()}
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)[:t_local]
    e_local = cfg.n_experts // n_ep
    for factor, dropping in ((1.25, True), (8.0, False)):
        cap = moe.ep_capacity(t_local, cfg.top_k, n_ep, factor)
        assert cap == min(max(8, -(-int(t_local * cfg.top_k / n_ep * factor)
                                   // 8) * 8), t_local * cfg.top_k)
        dropped = 0
        for m in range(n_ep):
            local = dict(p, **{k: p[k][m * e_local:(m + 1) * e_local]
                               for k in ("w_gate", "w_up", "w_down")})
            part = moe.ep_shard_partial(xf, local, cfg.top_k, m, n_ep, cap)
            mine = int(((part.idx // e_local) == m).sum())
            assert int(part.valid.sum()) == min(mine, cap)
            assert int(part.offs[-1]) == cap and int(part.offs[0]) == 0
            dropped += mine - int(part.valid.sum())
        assert (dropped > 0) == dropping


@pytest.mark.parametrize("case", [gate.case_id(*c) for c in gate.TRAIN_CASES])
def test_sharded_train_step_matches_jax(runs, case):
    got, want = runs[0]["train"][case], runs[1]["train"][case]
    cfg = gate.port_cfg(*dict((gate.case_id(*c), c)
                              for c in gate.TRAIN_CASES)[case])
    assert got["step"] == 1
    assert abs(float(got["loss"]) - want["loss"]) <= LOSS_ATOL
    assert_close(got["lr"], np.float32(LR))
    assert_close(got["grad_norm"], np.float32(want["grad_norm"]))
    wp = dict(zip(*tree.flatten_with_names(
        params_from_jax(want["params"], cfg, device="cpu"))))
    wm = dict(zip(*tree.flatten_with_names(
        params_from_jax(want["m"], cfg, device="cpu"))))
    assert sorted(got["names"]) == sorted(wp)
    for name, p, m in zip(got["names"], got["params"], got["m"]):
        g = np.abs(wm[name].numpy()) / 0.1        # m = 0.1 g at step one
        d = np.abs(p - wp[name].numpy())
        assert d[g >= GRAD_FLOOR].max(initial=0) <= PARAM_ATOL, name
        assert d.max() <= 2 * LR, name
        assert np.abs(m - wm[name].numpy()).max() <= \
            MOMENT_REL * np.abs(wm[name].numpy()).max(), name
    if cfg.is_moe:
        assert got["expert_counts"].dtype == np.int32
        assert_same(got["expert_counts"], want["expert_counts"])
    # the moments are laid out by the ZeRO specs: split over data somewhere
    assert any("Shard" in s.split(",")[0] for s in got["placements"])


def test_restore_onto_a_smaller_mesh(runs):
    """A ZeRO-laid-out olmoe tree saved from the (2, 4) mesh, restored onto
    the (1, 4) mesh ``plan_elastic_remesh`` plans after losing 4 chips
    (ranks 0-3), in that mesh's placements: the same whole tensors."""
    new_shape, step, same, kinds = runs[0]["restore"]
    assert new_shape == (1, 4) and step == 7 and same
    assert any("Shard" in k for k in kinds)
