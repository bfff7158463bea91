"""Asynchronous, atomic checkpointing (torch twin of
``repro.checkpoint.checkpointer``), on one device or over a mesh.

  * **step-atomic**: a checkpoint directory appears only by the rename of
    a fully written ``.tmp_step_N`` directory, so a crash mid-save never
    leaves a partial checkpoint that ``steps`` would list;
  * **asynchronous**: every leaf is copied to host memory before ``save``
    returns (a consistent snapshot, immune to later in-place updates of
    the live tensors); the files are written on a background thread;
  * **pipeline-exact resume**: the data pipeline is a function of the
    step, so the step integer is all the loader state there is;
  * **bounded retention**: the newest ``keep`` checkpoints stay;
  * **checked restore**: leaves are named by their path in the tree
    (``repro_torch.tree``); a restore whose names, shapes or dtypes differ
    from the checkpoint's raises;
  * **re-layout**: a DTensor leaf is saved whole (``full_tensor``, a
    gather every rank joins; rank 0 writes), and ``restore(...,
    shardings=)`` lays each leaf out on the mesh it is given, which may be
    smaller than the one that saved it (``plan_elastic_remesh``).

Leaves are torch tensors (any device; bfloat16 travels as its 16 bits),
DTensors or numpy arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _writes() -> bool:
    """Whether this process writes the files: rank 0 of a process group,
    or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_copy(x) -> np.ndarray:
    """A numpy copy of a leaf (a DTensor's whole tensor); bfloat16 as its
    int16 bits."""
    if _is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(x)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._save_error: BaseException | None = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, state, *, extra: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``state`` at ``step``: every leaf is copied to host
        memory now (the card is synchronised by the copy); the files are
        written on a thread unless ``block``.  With DTensor leaves every
        rank calls ``save`` and rank 0 alone writes."""
        self.wait()
        names, leaves = tree.flatten_with_names(state)
        host = [_host_copy(x) for x in leaves]
        if not _writes():
            return
        manifest = {
            "step": step,
            "names": names,
            "dtypes": [_dtype_name(x) for x in leaves],
            "shapes": [list(a.shape) for a in host],
            "extra": extra or {},
        }

        def write():
            try:
                tmp = self.dir / f".tmp_step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for i, arr in enumerate(host):
                    np.save(tmp / f"leaf_{i}.npy", arr)
                with open(tmp / "manifest.json", "w") as f:
                    json.dump(manifest, f)
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)            # the atomic commit
                self._gc()
            except BaseException as e:  # raised by the next save or wait
                self._save_error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("async checkpoint failed") from err

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, *, step: int | None = None, shardings=None):
        """(a tree shaped like ``like`` holding the checkpoint's values,
        its step, its ``extra``).  A tensor leaf of ``like`` comes back as
        a tensor on that leaf's device, a numpy leaf as a numpy array.
        ``shardings`` (the re-layout onto the current mesh): a tree shaped
        like ``like`` whose leaves are ``(mesh, placements)`` pairs, or
        None for a leaf that stays a plain tensor; each such leaf comes
        back a DTensor laid out so (every rank reads the files).  Raises
        ``ValueError`` where the checkpoint's leaf names, shapes or dtypes
        differ from ``like``'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step}"
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        names, leaves = tree.flatten_with_names(like)
        if names != manifest["names"]:
            raise ValueError(
                f"checkpoint/model structure mismatch: {len(names)} leaves "
                f"{names[:4]}... vs {len(manifest['names'])} "
                f"{manifest['names'][:4]}...")
        layouts = ([None] * len(names) if shardings is None
                   else _layout_leaves(shardings, names))
        out = []
        for i, (name, x) in enumerate(zip(names, leaves)):
            shape = list(x.shape)
            if (shape != manifest["shapes"][i]
                    or _dtype_name(x) != manifest["dtypes"][i]):
                raise ValueError(
                    f"checkpoint leaf {name}: {manifest['dtypes'][i]} "
                    f"{manifest['shapes'][i]} vs {_dtype_name(x)} {shape}")
            arr = np.load(path / f"leaf_{i}.npy")
            if isinstance(x, torch.Tensor):
                t = torch.from_numpy(arr)
                if x.dtype == torch.bfloat16:
                    t = t.view(torch.bfloat16)
                t = t.to(x.device)
                if layouts[i] is not None:
                    from torch.distributed.tensor import distribute_tensor
                    mesh, placements = layouts[i]
                    t = distribute_tensor(t, mesh, placements)
                out.append(t)
            else:
                out.append(arr)
        return tree.unflatten(like, out), manifest["step"], \
            manifest.get("extra", {})


def _layout_leaves(shardings, names: list[str]) -> list:
    """The ``(mesh, placements)`` pair (or None) of each leaf path in
    ``names``, looked up in ``shardings`` by path (the pairs are tuples,
    which the tree helpers would walk into)."""
    out = []
    for name in names:
        node = shardings
        for key in name.split("/") if name else ():
            if node is None:
                break
            if isinstance(node, dict):
                node = node[key]
            elif tree._is_namedtuple(node):
                node = getattr(node, key)
            else:
                node = node[int(key)]
        out.append(node)
    return out
