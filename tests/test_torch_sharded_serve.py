"""The port's ``prefill`` and ``decode_step`` with a mesh against the JAX
package's, on the CPU: 8 gloo processes form a (2, 4) ``("data",
"model")`` DeviceMesh once for the file
(``tests/helpers/torch_sharded_gate.py``'s ``torch_serve_ranks``), and a
JAX subprocess runs ``prefill``/``decode_step`` with ``mi`` on 8
placeholder devices, on the same weights (the port's seeded
``init_params``, stacked for JAX) and tokens.

Cases (``SERVE_CASES``, smoke width, float32): qwen3 (heads over
``model``), gemma3 (16-slot local rings that wrap in the prompt, tied
and scaled embeddings), olmoe (expert-parallel MoE at capacity 8.0),
mixtral (tensor-parallel MoE, 2 experts, rings), mamba2, zamba2 (Mamba-2
heads over ``model``, the conv context's channels over ``model``, a
shared-attention cache), qwen3 with int8 caches and qwen3 with
``attn_q_chunk`` 8 (JAX chunks the prompt's queries; the port's prompt
attention is K8, flash-style).  A 24-token prompt into 40 slots split
over ``model`` (10 a rank), then 5 forced decode tokens.  Every step's
logits within ``LOGIT_REL`` of the largest JAX logit (float32 summed in
other orders, across ranks and packages; int8 caches ``INT8_LOGIT_REL``:
a K/V value on a rounding edge may land one int8 step apart, as in
``test_torch_dense_cache_attn.py``, which moves a logit by ~1e-4 of the
largest here) and the same argmax; the positions equal; the caches'
slots split over ``model``.

The file also holds the dry run's collective accounting against a real
run: the meta trace of the dry run's (2, 4) train cell
(``DRYRUN_TRAIN``, bf16 smoke olmoe on the fake backend) issues exactly
the functional collectives that ``CommDebugMode`` counted on rank 0 of
the same step run for real over gloo.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

from helpers import torch_sharded_gate as gate

LOGIT_REL = 1e-4
INT8_LOGIT_REL = 1e-3
WORLD = gate.MESH[0] * gate.MESH[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_serve")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    jax_out, torch_out = d / "jax.pkl", d / "torch.pkl"
    proc = subprocess.Popen([sys.executable, gate.__file__, "jax-serve",
                             str(jax_out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(gate.torch_serve_ranks,
                 args=(WORLD, f"file://{d}/rdv", str(torch_out)),
                 nprocs=WORLD)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    with open(torch_out, "rb") as f:
        got = pickle.load(f)
    return got, want


@pytest.mark.parametrize("case", [gate.case_id(*c) for c in gate.SERVE_CASES])
def test_sharded_prefill_decode_match_jax(runs, case):
    got, want = runs[0]["serve"][case], runs[1][case]
    cfg = gate.port_cfg(*dict((gate.case_id(*c), c)
                              for c in gate.SERVE_CASES)[case])
    assert len(got["logits"]) == len(want["logits"]) == gate.SERVE_NEW + 1
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, step
        big = np.abs(w[..., :cfg.vocab]).max()
        err = np.abs(g - w)[..., :cfg.vocab].max()
        rel = INT8_LOGIT_REL if cfg.kv_cache_quant else LOGIT_REL
        assert err <= rel * big, (step, err, big)
        np.testing.assert_array_equal(g[..., :cfg.vocab].argmax(-1),
                                      w[..., :cfg.vocab].argmax(-1))
    np.testing.assert_array_equal(got["positions"], want["positions"])
    # the caches' slots are split over model (the mesh's second dim)
    assert any("Shard(dim=1)" in p.split(", ")[1]
               for p in got["placements"] if p.count("Shard") == 2)


def test_collective_counts_match_gloo_run(runs):
    from repro_torch.launch.dryrun import trace_config
    from repro_torch.launch.mesh import (fake_world, make_debug_mesh,
                                         make_mesh_info)
    arch, tweak, shape = gate.DRYRUN_TRAIN
    real = runs[0]["dryrun_train"]
    with fake_world(WORLD):
        mi = make_mesh_info(make_debug_mesh(*gate.MESH, device_type="cpu"))
        res = trace_config(gate.port_cfg(arch, tweak),
                           gate.shape_config(shape), mi)
    # CommDebugMode files the functional collectives under their legacy
    # names (``c10d_functional.*``)
    name = lambda k: k.removeprefix("_")
    assert {name(k): v for k, v in res["collectives"]["ops"].items()} == \
        {name(k): v for k, v in real.items()}
    assert sum(real.values()) > 0
