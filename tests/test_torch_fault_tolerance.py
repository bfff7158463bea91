"""The port's fault-tolerance planner and ZeRO specs against the JAX
package: ``HeartbeatMonitor``, ``StragglerPolicy``, ``plan_elastic_remesh``,
``adamw.zero_spec`` and ``launch.specs.plan_microbatches``.  All of it is
host logic, so the results must be equal."""
from types import SimpleNamespace

import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.checkpoint import HeartbeatMonitor as JHeartbeat
from repro.checkpoint import StragglerPolicy as JStraggler
from repro.checkpoint import plan_elastic_remesh as jplan
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch.specs import plan_microbatches as jplan_micro
from repro.optim import adamw as jadamw
from repro.parallel.sharding import MeshInfo as JMeshInfo
from repro_torch.checkpoint import (HeartbeatMonitor, StragglerPolicy,
                                    plan_elastic_remesh)
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch.specs import CACHE_PAD, plan_microbatches
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import MeshInfo

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 4), ("data", "model"))]


def mesh_infos(shape, axes):
    """The two packages' ``MeshInfo`` over a mesh without devices."""
    dp = tuple(a for a in axes if a != "model")
    port = MeshInfo(SimpleNamespace(mesh_dim_names=axes, shape=shape),
                    dp_axes=dp)
    return port, JMeshInfo(AbstractMesh(shape, axes), dp_axes=dp)


def _beats(cls):
    hb = cls(n_hosts=4, dead_timeout_s=10, straggler_factor=2.5)
    now = 1000.0
    for h in range(4):
        for _ in range(5):
            hb.beat(h, 1.0 if h != 2 else 4.0, now=now)
    return (hb.stragglers(), hb.dead_hosts(now=now + 20),
            hb.dead_hosts(now=now + 1))


def _policy(cls):
    pol = cls(patience=2)
    seen = [pol.observe([2]) for _ in range(4)]
    return seen + [pol.observe([]), pol.observe([1, 3]), pol.observe([3])]


def test_heartbeat_and_straggler_policy():
    """Twin of ``test_train_integration::test_heartbeat_and_straggler_policy``:
    the same flags, dead hosts and actions as the JAX package's."""
    got, want = _beats(HeartbeatMonitor), _beats(JHeartbeat)
    assert got == want
    assert got[0] == [2] and got[1] == [0, 1, 2, 3] and got[2] == []
    acts = _policy(StragglerPolicy)
    assert acts == _policy(JStraggler)
    assert acts[3][2] == "remesh" and acts[4] == {}


def _plan_fields(plan):
    return (plan.old_shape, plan.new_shape, plan.axes, plan.grad_accum_scale,
            plan.chips_before, plan.chips_after)


def test_elastic_remesh_plan():
    """Twin of ``test_train_integration::test_elastic_remesh_plan``."""
    plan = plan_elastic_remesh((2, 16, 16), ("pod", "data", "model"),
                               lost_chips=16)
    assert _plan_fields(plan) == _plan_fields(
        jplan((2, 16, 16), ("pod", "data", "model"), lost_chips=16))
    assert plan.new_shape[-1] == 16
    assert plan.chips_after <= 512 - 16
    assert plan.grad_accum_scale >= 2
    plan2 = plan_elastic_remesh((16, 16), ("data", "model"), lost_chips=1)
    assert plan2.new_shape == (8, 16)
    with pytest.raises(AssertionError):
        plan_elastic_remesh((16, 16), ("model", "data"), lost_chips=1)


def test_zero_spec_shards_an_unsharded_dim():
    """Twin of ``test_train_integration::test_zero_spec_shards_an_unsharded_dim``:
    a spec is a plain tuple, equal to the JAX spec read as one."""
    cases = [((80, 4096, 32, 128), (None, None, "model", None), ("data",), 16),
             ((81, 3584), (None, "model"), ("data",), 16),
             ((16, 2048), (None,), ("pod", "data"), 8),
             ((0, 8), (), ("data",), 2)]
    for shape, spec, dp, n in cases:
        got = adamw.zero_spec(shape, spec, dp, n)
        assert got == tuple(jadamw.zero_spec(shape, P(*spec), dp, n))
    assert adamw.zero_spec(*cases[0])[0] == "data"
    assert adamw.zero_spec(*cases[1]) == (None, "model")
    assert adamw.zero_spec(*cases[2]) == (("pod", "data"), None)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_match_jax_over_every_shape_and_mesh(arch, mesh):
    """``plan_microbatches`` for every input shape on the mesh and on each
    mesh ``plan_elastic_remesh`` shrinks it to after losing 1, a model
    group's worth, or half of its chips: plans equal the JAX package's."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shape, axes = mesh
    total = 1
    for s in shape:
        total *= s
    assert CACHE_PAD == 512
    meshes = [shape]
    for lost in (1, shape[-1], total // 2):
        plan = plan_elastic_remesh(shape, axes, lost)
        assert _plan_fields(plan) == _plan_fields(jplan(shape, axes, lost))
        meshes.append(plan.new_shape)
    for m in meshes:
        mi, jmi = mesh_infos(m, axes)
        assert (mi.n_data, mi.n_model) == (jmi.n_data, jmi.n_model)
        for name, sc in SHAPES.items():
            got = plan_microbatches(cfg, sc, mi)
            want = jplan_micro(jcfg, JSHAPES[name], jmi)
            assert (got.n_micro, got.micro_batch, got.cache_len) == \
                (want.n_micro, want.micro_batch, want.cache_len), (m, name)
