"""Mesh construction (torch twin of ``repro.launch.mesh``).

Every function builds a ``DeviceMesh`` over the default process group,
which the caller has set up (``torch.distributed.init_process_group``
with its address, world size and rank) with as many ranks as the mesh
has places.  The production meshes of 256 and 512 ranks exist only
under the ``fake`` backend, which traces collectives without devices
(``fake_world``), as ``"cpu"`` meshes.
"""
from __future__ import annotations

from contextlib import contextmanager

from repro_torch.parallel.sharding import MeshInfo


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group on torch's ``fake`` backend (a
    ``FakeStore``): ``world_size`` ranks of which this process is
    ``rank``, collectives traced and never run, no device and no peer.
    The dry run builds the production meshes on it over meta tensors (the
    JAX dry run's placeholder devices).  The group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh_info(mesh, *, seq_shard: bool = True) -> MeshInfo:
    """The mesh's roles: every axis but ``model`` carries data."""
    axes = tuple(mesh.mesh_dim_names)
    return MeshInfo(mesh=mesh, dp_axes=tuple(a for a in axes if a != "model"),
                    model_axis="model", seq_shard=seq_shard)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh, for tests over a few processes
    (``device_type="cpu"`` with the ``gloo`` backend)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
