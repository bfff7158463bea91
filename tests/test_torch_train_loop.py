"""The port's training loop on the CPU at smoke width: twins of the
single-host cases of ``tests/test_train_integration.py`` (the loss
falls, a resume is bit exact, a crash recovers from its checkpoint, the
data pipeline is deterministic and sharded, the prefetcher keeps order),
of the five ``tests/test_checkpoint.py`` cases, and of the JAX launcher's
``main`` (the same lines, step numbers and, on the JAX weights, losses
within 1e-3: the printed four decimals plus the float32 tolerance).
"""
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import get_arch, smoke
from repro_torch.data import Prefetcher, ShardInfo, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw

cap_threads()


def _leaves_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


def test_loss_decreases_dense():
    cfg = smoke(get_arch("qwen3_4b"))
    losses, _, _ = train_loop(cfg, steps=40, global_batch=8, seq_len=32,
                              n_micro=2, log_every=0, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[::8]


def test_checkpoint_resume_is_bit_exact():
    cfg = smoke(get_arch("phi3_mini_3_8b"))
    kw = dict(global_batch=4, seq_len=16, n_micro=1, log_every=0,
              device="cpu")
    with tempfile.TemporaryDirectory() as d:
        losses_a, params_a, opt_a = train_loop(cfg, steps=20, **kw)
        losses_b1, _, _ = train_loop(cfg, steps=10, ckpt_dir=d,
                                     ckpt_every=10, **kw)
        losses_b2, params_b, opt_b = train_loop(cfg, steps=20, ckpt_dir=d,
                                                ckpt_every=10, **kw)
        assert losses_b1 == losses_a[:10]
        assert losses_b2 == losses_a[10:]       # bit for bit
        _leaves_equal(params_a, params_b)
        _leaves_equal(opt_a, opt_b)
        assert int(opt_b.step) == 20


def test_crash_recovery():
    cfg = smoke(get_arch("mamba2_1_3b"))
    kw = dict(steps=20, global_batch=4, seq_len=16, n_micro=1, log_every=0,
              device="cpu")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="simulated crash"):
            train_loop(cfg, ckpt_dir=d, ckpt_every=5, crash_at=12, **kw)
        assert Checkpointer(d).steps() == [5, 10]
        losses, _, opt = train_loop(cfg, ckpt_dir=d, ckpt_every=5, **kw)
        assert len(losses) == 10  # resumed from step 10, not from scratch
        assert int(opt.step) == 20


def test_moe_training_is_refused():
    cfg = smoke(get_arch("olmoe_1b_7b"))
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        train_loop(cfg, steps=1, device="cpu")


def test_data_pipeline_deterministic_and_sharded():
    a = SyntheticLM(100, 16, 8, seed=3)
    b = SyntheticLM(100, 16, 8, seed=3)
    np.testing.assert_array_equal(a.batch(7)["tokens"], b.batch(7)["tokens"])
    assert not np.array_equal(a.batch(7)["tokens"], a.batch(8)["tokens"])
    s0 = SyntheticLM(100, 16, 8, seed=3, shard=ShardInfo(0, 2))
    s1 = SyntheticLM(100, 16, 8, seed=3, shard=ShardInfo(1, 2))
    b0, b1 = s0.batch(0)["tokens"], s1.batch(0)["tokens"]
    assert b0.shape == (4, 16)
    assert not np.array_equal(b0, b1)
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(100, 16, 7, shard=ShardInfo(0, 2))


def test_prefetcher_orders_batches():
    src = SyntheticLM(50, 8, 4, seed=0)
    pf = Prefetcher(src, start_step=5, depth=2)
    try:
        got = [pf.next() for _ in range(4)]
        assert [s for s, _ in got] == [5, 6, 7, 8]
        for s, batch in got:
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch(s)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# --- the checkpointer (twins of tests/test_checkpoint.py) --------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32),
                  "h": torch.linspace(-1, 1, 5).to(torch.bfloat16)},
            "s": adamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                                  [torch.zeros(2)], [torch.ones(2)])}


def test_save_restore_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t = _tree()
        ck.save(3, t, extra={"note": "hi"}, block=True)
        like = tree.map_leaves(torch.zeros_like, _tree())
        restored, step, extra = ck.restore(like)
        assert step == 3 and extra == {"note": "hi"}
        assert isinstance(restored["s"], adamw.AdamWState)
        names, got = tree.flatten_with_names(restored)
        assert names[-1] == "s/v/0"
        for a, b in zip(tree.leaves(t), got):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_retention_keeps_newest():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, _tree(), block=True)
        assert ck.steps() == [3, 4]
        assert ck.latest_step() == 4


def test_no_partial_checkpoint_visible():
    """Temp dirs never surface as restorable steps."""
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, _tree(), block=True)
        (Path(d) / ".tmp_step_9").mkdir()       # simulated crashed writer
        assert ck.steps() == [1]
        _, step, _ = ck.restore(_tree())
        assert step == 1


@pytest.mark.parametrize("like", [
    {"different": torch.zeros(3)},
    {**_tree(), "a": torch.zeros(3, 2)},                  # shape
    {**_tree(), "a": torch.zeros(2, 3, dtype=torch.float64)}])  # dtype
def test_structure_mismatch_rejected(like):
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, _tree(), block=True)
        with pytest.raises(ValueError, match="mismatch|checkpoint leaf"):
            ck.restore(like)


def test_snapshot_consistency_under_mutation():
    """The host snapshot is taken synchronously: mutating the live tree
    after save() must not affect what lands on disk."""
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t = {"x": torch.zeros(4), "y": np.zeros(4)}
        ck.save(1, t)
        t["x"].fill_(99.0)                      # mutate while writer runs
        t["y"][:] = 99.0
        ck.wait()
        restored, _, _ = ck.restore({"x": torch.ones(4), "y": np.ones(4)})
        assert torch.equal(restored["x"], torch.zeros(4))
        np.testing.assert_array_equal(restored["y"], np.zeros(4))


# --- the launcher's main -----------------------------------------------------

_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)$")
_FINAL = re.compile(r"^final loss (\S+) \(from (\S+)\)$")


def _parse(lines):
    out = []
    for line in lines:
        m = _LINE.match(line) or _FINAL.match(line)
        assert m, line
        out.append((line.split()[0], [float(x) for x in m.groups()]))
    return out


def test_main_prints_what_jax_prints(capsys, monkeypatch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jget_arch
    from repro.configs import smoke as jsmoke
    from repro.launch import train as JTrain
    from repro.models import transformer as JT
    from repro_torch.convert import params_from_jax
    argv = ["--arch", "qwen3_4b", "--smoke", "--steps", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    JTrain.main()
    want = capsys.readouterr().out.splitlines()

    jp = jax.tree.map(np.asarray, JT.init_params(
        jsmoke(jget_arch("qwen3_4b")), jax.random.PRNGKey(0)))
    monkeypatch.setattr(
        train.T, "init_params",
        lambda cfg, seed, device: params_from_jax(jp, cfg, device=device))
    assert train.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2
    for (gk, gv), (wk, wv) in zip(_parse(got), _parse(want)):
        assert gk == wk
        np.testing.assert_allclose(gv, wv, atol=1e-3, rtol=0)
