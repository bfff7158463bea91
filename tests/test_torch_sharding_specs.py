"""The port's sharding policy against the JAX package's: ``attn_mode``,
``param_specs``, ``act_spec``, ``kv_cache_spec`` and the ZeRO specs for
every arch of the registry on the production meshes (16 x 16 and
2 x 16 x 16) and two small ones.  Specs are host state: each must equal
the JAX ``PartitionSpec`` read as a tuple.  No device is needed: the
meshes are stand-ins with their axis names and sizes."""
from dataclasses import replace
from types import SimpleNamespace

import pytest
import jax
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jget_arch
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro_torch import tree
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.launch.train import param_shapes
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 4), ("data", "model"))]


def mesh_infos(shape, axes):
    dp = tuple(a for a in axes if a != "model")
    port = sh.MeshInfo(SimpleNamespace(mesh_dim_names=axes, shape=shape),
                       dp_axes=dp)
    return port, jsh.MeshInfo(AbstractMesh(shape, axes), dp_axes=dp)


def as_tuples(jtree):
    """A JAX spec tree with each ``PartitionSpec`` read as a tuple."""
    return jax.tree.map(tuple, jtree, is_leaf=lambda x: isinstance(x, P))


def stacked(specs):
    """The port's spec tree in the JAX layout: the layer list as one
    dict whose leaves lead with the (unsplit) layer dim."""
    def lead(node):
        if isinstance(node, dict):
            return {k: lead(v) for k, v in node.items()}
        return (None, *node)
    assert all(lp == specs["layers"][0] for lp in specs["layers"])
    return dict(specs, layers=lead(specs["layers"][0]))


def _one_block(cfg):
    """The arch with its fewest layers that still have every leaf kind (a
    hybrid keeps one shared site): all layers' leaves have one shape."""
    return replace(cfg, n_layers=cfg.shared_attn_every or 1)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, mesh):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    mi, jmi = mesh_infos(*mesh)
    assert sh.attn_mode(cfg, mi) == jsh.attn_mode(jcfg, jmi)
    for fsdp in (False, True):
        port = sh.param_specs(cfg, mi, fsdp_attn=fsdp)
        assert len(port["layers"]) == cfg.n_layers
        want = as_tuples(jsh.param_specs(jcfg, jmi, fsdp_attn=fsdp))
        assert stacked(port) == want
    for seq in (True, False):
        assert sh.act_spec(cfg, mi, seq=seq) == tuple(
            jsh.act_spec(jcfg, jmi, seq=seq))
    assert sh.kv_cache_spec(mi) == tuple(jsh.kv_cache_spec(jmi))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero_specs_equal_jax(arch, mesh):
    """``zero_specs`` of the port's per-layer tree equals the JAX
    ``zero_spec`` of each leaf's shape and spec, and ``zero_spec`` of the
    stacked shapes and specs equals JAX ``zero_specs`` of the stacked
    tree (where the layer dim is the first one it may split)."""
    cfg = _one_block(get_arch(arch))
    mi, jmi = mesh_infos(*mesh)
    shapes = param_shapes(cfg)
    specs = sh.param_specs(cfg, mi)
    zs = adamw.zero_specs(shapes, specs, mi.dp_axes, mi.n_data)
    names, leaves = tree.flatten_with_names(shapes)
    for name, leaf, spec, z in zip(names, leaves, sh.spec_leaves(specs, shapes),
                                   sh.spec_leaves(zs, shapes)):
        want = jadamw.zero_spec(tuple(leaf.shape), P(*spec), jmi.dp_axes,
                                jmi.n_data)
        assert z == tuple(want), name
    n_layers = get_arch(arch).n_layers
    port_stacked = stacked(specs)
    jstacked = jsh.param_specs(jget_arch(arch), jmi)
    lay = shapes["layers"][0]
    jshapes = {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32")
               for k, v in shapes.items() if k not in ("layers", "shared")}
    jshapes["layers"] = jax.tree.map(
        lambda t: jax.ShapeDtypeStruct((n_layers, *t.shape), "float32"),
        lay, is_leaf=lambda x: hasattr(x, "shape"))
    if "shared" in shapes:
        jshapes["shared"] = jax.tree.map(
            lambda t: jax.ShapeDtypeStruct(tuple(t.shape), "float32"),
            shapes["shared"], is_leaf=lambda x: hasattr(x, "shape"))
    want = as_tuples(jadamw.zero_specs(jshapes, jstacked, jmi.dp_axes,
                                       jmi.n_data))
    got = jax.tree.map(
        lambda s, p: adamw.zero_spec(tuple(s.shape), p, mi.dp_axes,
                                     mi.n_data), jshapes, port_stacked,
        is_leaf=lambda x: isinstance(x, tuple))
    assert got == want


def test_placements_follow_the_spec():
    """One entry per tensor dim becomes one placement per mesh dim; a dim
    split over two axes takes them in mesh order; an axis used twice, an
    axis out of mesh order or one the mesh lacks is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 2, 2))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sh.placements((), mesh) == (Replicate(),) * 3
    for bad in ((("data", "pod"),), ("model", "model"), ("x",)):
        with pytest.raises(ValueError):
            sh.placements(bad, mesh)


def test_constrain_without_a_mesh_is_the_identity():
    import torch
    x = torch.ones(3)
    assert sh.constrain(x, None, ("data",)) is x
