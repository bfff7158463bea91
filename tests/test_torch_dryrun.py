"""The port's dry run (``repro_torch.launch.dryrun``: the fake backend,
meta tensors) against the JAX package's lowering of the same cells, and
the pieces only the dry run reaches.

  * The dry run's four kinds of cell at small shapes
    (``torch_sharded_gate.DRYRUN_CELLS``: smoke olmoe training, qwen3
    prefill, gemma3 decode into a 4096-slot cache, zamba2 long-context
    decode with batch 1) on a (2, 4) mesh of 8 fake ranks, against JAX's
    ``lower_cell`` code path on 8 placeholder devices (a subprocess,
    ``torch_sharded_gate.py jax-dryrun``): the plan, every parameter's
    and input's shape, dtype and spec (JAX's stacked layer leaves
    without their layer entry), and the rank's
    ``argument_size_in_bytes`` equal.  The operation counts of both are
    printed side by side, not gated: XLA counts its fused CPU program,
    the port its local ops and kernels' formulas.
  * ``sdpa_qchunked`` against JAX's (values and gradients within
    ``ATOL``/``RTOL``), and its fallback to ``sdpa``.
  * The kernel wrappers on meta tensors: outputs of the kernels' shapes
    and types, the formulas' operations in ``kernels.meta_flops()``,
    nothing counted as a launch.
  * ``dryrun.main``'s refusals and ``run_and_save``'s error record.

Every fake world is opened by ``launch.mesh.fake_world``, which destroys
the default group on leaving it.
"""
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import torch_sharded_gate as gate
from helpers.torch_parity import assert_close, cap_threads
from repro.models import attention as JA
from repro_torch import kernels, tree
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_world, make_debug_mesh, make_mesh_info
from repro_torch.models import attention as A
from repro_torch.parallel import sharding as sh

cap_threads()
WORLD = gate.MESH[0] * gate.MESH[1]


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dryrun") / "jax.pkl"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, gate.__file__, "jax-dryrun",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _path(key: str) -> tuple:
    return tuple(re.findall(r"\[(?:'([^']*)'|(\d+))\]", key))


def _jax_leaves(described, stacked: bool) -> dict:
    """JAX's (shape, dtype, spec) by port leaf name; a stacked layer
    leaf stands for each of the port's layers, without its layer entry."""
    out = {}
    for key, shape, dtype, spec in described:
        parts = ["".join(p) for p in _path(key)]
        if stacked and parts[0] == "layers":
            for l in range(shape[0]):
                out["/".join(["layers", str(l), *parts[1:]])] = (
                    shape[1:], dtype, spec[1:])
        else:
            out["/".join(parts)] = (shape, dtype, spec)
    return out


def _port_leaves(structs, specs) -> dict:
    names, leaves = tree.flatten_with_names(structs)
    return {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                gate._norm_spec(s, t.dim()))
            for n, t, s in zip(names, leaves, sh.spec_leaves(specs, structs))}


@pytest.mark.parametrize("kind", list(gate.DRYRUN_CELLS))
def test_dryrun_cell_matches_jax(jax_cells, kind):
    want = jax_cells[kind]
    arch, tweak, spec = gate.DRYRUN_CELLS[kind]
    cfg, shape = gate.port_cfg(arch, tweak), gate.shape_config(spec)
    with fake_world(WORLD):
        mi = make_mesh_info(make_debug_mesh(*gate.MESH, device_type="cpu"))
        plan = S.plan_microbatches(cfg, shape, mi)
        assert (plan.n_micro, plan.micro_batch, plan.cache_len) == \
            want["plan"]
        assert _port_leaves(S.param_struct(cfg), sh.param_specs(cfg, mi)) \
            == _jax_leaves(want["params"], stacked=True)
        if kind == "train":
            inputs = S.train_input_specs(cfg, shape, mi, force_n_micro=1)
        elif kind == "prefill":
            inputs = S.prefill_input_specs(cfg, shape, mi)
        else:
            state, sspecs, *inputs = S.decode_input_specs(cfg, shape, mi)
            assert _port_leaves(state, sspecs) == \
                _jax_leaves(want["state"], stacked=False)
        assert _port_leaves(*inputs) == _jax_leaves(want["inputs"],
                                                    stacked=False)
        res = D.trace_config(cfg, shape, mi, analysis=True)
    mem = res["memory"]
    assert mem["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    print(f"\n{kind}: flops port {res['cost']['flops']:.4g} "
          f"(kernels {sum(res['cost']['kernel_flops'].values()):.4g}) "
          f"jax {want['flops']:.4g}; temp port "
          f"{mem['temp_size_in_bytes']} jax "
          f"{want['memory']['temp_size_in_bytes']}")
    assert res["cost"]["flops"] > 0 and want["flops"] > 0


@pytest.mark.parametrize("arch,spec", [
    ("musicgen_medium", ("train_s", 32, 8, "train")),
    ("qwen2_vl_72b", ("train_s", 32, 8, "train")),
    ("qwen2_vl_72b", ("prefill_s", 64, 4, "prefill"))])
def test_dryrun_embeds_archs(arch, spec):
    """The embeds archs' cells trace: their table takes no gradient (the
    sharded step sums zeros for it) and qwen2_vl's M-RoPE table is built
    without a data-dependent op."""
    with fake_world(WORLD):
        mi = make_mesh_info(make_debug_mesh(*gate.MESH, device_type="cpu"))
        res = D.trace_config(gate.port_cfg(arch, {}),
                             gate.shape_config(spec), mi, analysis=True)
    assert res["memory"]["argument_size_in_bytes"] > 0
    assert res["cost"]["flops"] > 0


@pytest.mark.parametrize("Sq,q_chunk,window", [(32, 8, None), (32, 8, 5),
                                               (24, 8, 0), (8, 8, None)])
def test_sdpa_qchunked_matches_jax(Sq, q_chunk, window):
    rng = np.random.default_rng(Sq + q_chunk)
    B, Hq, Hkv, D_ = 2, 4, 2, 16
    q = rng.standard_normal((B, Sq, Hq, D_), dtype=np.float32)
    k = rng.standard_normal((B, Sq, Hkv, D_), dtype=np.float32)
    v = rng.standard_normal((B, Sq, Hkv, D_), dtype=np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    cot = rng.standard_normal((B, Sq, Hq, D_), dtype=np.float32)

    def jf(q, k, v):
        out = JA.sdpa_qchunked(q, k, v, jnp.asarray(pos), window=window,
                               q_chunk=q_chunk, unrolled=True)
        return jnp.sum(out * cot), out
    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = A.sdpa_qchunked(tq, tk, tv, torch.from_numpy(pos), window=window,
                          q_chunk=q_chunk)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_close(out, jout)
    for g, w in zip((tq.grad, tk.grad, tv.grad), jg):
        assert_close(g, w)


def test_kernel_wrappers_on_meta_tensors():
    from repro_torch.kernels import flash_attention as K8
    from repro_torch.kernels import moe_ffn as KM
    from repro_torch.kernels import ssd_scan as K9
    m = dict(device="meta")
    kernels.reset_meta_flops()
    launches = kernels.launch_counts()
    q = torch.empty((2, 64, 8, 32), dtype=torch.bfloat16, **m)
    kv = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, **m)
    out = K8.flash_attention(q, kv, kv, causal=True, window=16)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    pairs = sum(min(i + 1, 16) for i in range(64))
    assert K8.key_pairs(64, 64, True, 16, 64) == pairs
    y, h = K9.ssd_scan(torch.empty((2, 40, 4, 16), **m),
                       torch.empty((2, 40, 4), **m), torch.empty((4,), **m),
                       torch.empty((2, 40, 1, 8), **m),
                       torch.empty((2, 40, 1, 8), **m), 16)
    assert y.shape == (2, 40, 4, 16) and h.shape == (2, 4, 8, 16)
    assert y.dtype == h.dtype == torch.float32
    R, d, ff, E = 48, 64, 128, 4
    xg = torch.empty((R, d), dtype=torch.bfloat16, **m)
    ws = (torch.empty((E, d, ff), dtype=torch.bfloat16, **m),
          torch.empty((E, d, ff), dtype=torch.bfloat16, **m),
          torch.empty((E, ff, d), dtype=torch.bfloat16, **m))
    offs = torch.empty((E + 1,), dtype=torch.int32, **m)
    gate_w = torch.empty((R,), **m)
    assert KM.moe_ffn(xg, offs, *ws, gate_w).shape == (R, d)
    yt, g, u, hh = KM.moe_ffn_train(xg, offs, *ws, gate_w)
    assert hh.dtype == torch.bfloat16 and g.dtype == torch.float32
    grads = KM.moe_ffn_backward(torch.empty((R, d), **m), xg, offs, *ws,
                                gate_w, g, u, hh)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 4 + [torch.float32]
    assert [t.shape for t in grads[1:4]] == [w.shape for w in ws]
    flops = kernels.meta_flops()
    assert flops["flash_attention"] == 4.0 * 2 * 8 * 32 * pairs
    assert flops["ssd_scan"] == K9.scan_flops(2, 40, 4, 16, 8, 16)
    assert flops["moe_ffn"] == 2 * 6.0 * R * d * ff
    assert flops["moe_ffn_bwd"] == 12.0 * R * d * ff
    assert kernels.launch_counts() == launches


def test_main_refuses_save_hlo_and_records_errors(tmp_path):
    with pytest.raises(SystemExit, match="no HLO"):
        D.main(["--arch", "qwen3_4b", "--shape", "train_4k", "--save-hlo"])
    with fake_world(256):
        res = D.run_and_save("no_such_arch", "train_4k", multi_pod=False,
                             out_dir=tmp_path)
    assert res["status"] == "error" and "traceback" in res
    assert (tmp_path / "no_such_arch__train_4k__16x16.json").exists()
