"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or any module of the JAX package, and its
entry points refuse to run on a card that is not there instead of falling
back to the CPU."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.qos import LATENCY_CRITICAL, QoSConfig, tenant_for_class

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter where ``import jax`` fails; no ``repro``/``repro.*``
    module may be loaded afterwards."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any "import jax" now raises
        sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]
        import repro_torch
        names = ["chip_smoke"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith(("repro.", "jax.",
                                                      "jaxlib")))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.kernels.moe_ffn"])
def test_moe_modules_import_without_jax(module):
    """The MoE slice's modules, imported alone with ``jax`` blocked: no
    ``repro``/``jax`` module loads, and ``moe_ffn`` and its backward
    ``moe_ffn_bwd`` are counted kernels."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.path[:0] = [{str(SRC)!r}]
        importlib.import_module({module!r})
        from repro_torch import kernels
        assert all(k in kernels.KERNELS for k in ("moe_ffn", "moe_ffn_bwd"))
        assert kernels.launch_counts()["moe_ffn"] == 0
        assert kernels.launch_counts()["moe_ffn_bwd"] == 0
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith(("repro.", "jax.",
                                                      "jaxlib")))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.optim", "repro_torch.data",
    "repro_torch.checkpoint", "repro_torch.tree",
    "repro_torch.launch.train_moe_tiered"])
def test_training_modules_import_without_jax(module):
    """The training slice's modules, imported alone with ``jax``
    blocked: no ``repro``/``jax`` module loads and no kernel launches."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.path[:0] = [{str(SRC)!r}]
        importlib.import_module({module!r})
        from repro_torch import kernels
        assert not any(kernels.launch_counts().values())
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith(("repro.", "jax.",
                                                      "jaxlib")))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.checkpoint.fault_tolerance", "repro_torch.launch.dryrun"])
def test_multi_device_modules_import_without_jax(module):
    """The multi-device slice's modules, imported alone with ``jax``
    blocked: no ``repro``/``jax`` module loads, no kernel launches and
    no process group is set up by the import."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.path[:0] = [{str(SRC)!r}]
        importlib.import_module({module!r})
        import torch.distributed as dist
        from repro_torch import kernels
        assert not any(kernels.launch_counts().values())
        assert not dist.is_initialized()
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith(("repro.", "jax.",
                                                      "jaxlib")))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_or_repro_import():
    """The same rule read from the sources, so an import inside a function
    that the import test never calls is caught too."""
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import jax", "from jax", "import repro.",
                             "from repro ", "from repro.")) \
                    or s in ("import repro",):
                bad.append(f"{f.relative_to(ROOT)}:{i}: {s}")
    assert not bad, bad


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


@pytest.mark.parametrize("entry", ["init_params", "TierStore",
                                   "PagedServingEngine", "quickstart",
                                   "serve_paged", "longctx_decode",
                                   "train_loop", "train"])
def test_entry_points_raise_without_cuda(entry):
    """With no CUDA and no explicit ``device="cpu"`` every entry point
    raises (the launch scripts with no ``--device``); it never falls back
    quietly."""
    _no_card()
    from repro_torch.configs.base import registry, smoke
    from repro_torch.core.tiers import TierConfig, TierStore
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine, ServeConfig
    cfg = smoke(registry()["qwen3_4b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry in ("quickstart", "serve_paged", "longctx_decode",
                     "train"):
            import importlib
            importlib.import_module(f"repro_torch.launch.{entry}").main([])
        elif entry == "train_loop":
            from repro_torch.launch.train import train_loop
            train_loop(cfg, steps=1)
        elif entry == "init_params":
            init_params(cfg)
        elif entry == "TierStore":
            TierStore(TierConfig(n_pages=4, fast_slots=2, slow_slots=4,
                                 page_shape=(2,)))
        else:
            params = init_params(cfg, device="cpu")
            PagedServingEngine(cfg, params, ServeConfig())


@pytest.mark.parametrize("field,value", [
    ("overlap_plan", True),
    ("qos", QoSConfig(tenants=(tenant_for_class("lc", LATENCY_CRITICAL),),
                      power_budget_mw=1.0))])
def test_serve_config_refuses_unported_features(field, value):
    """Both features are ported and accepted: ``overlap_plan`` builds an
    engine whose memos runs the asynchronous pass with the ladder's top
    rung at overlap; ``qos`` with tenants and a budget builds a
    priority-aware batcher and a power governor at that budget."""
    from repro_torch.configs.base import registry, smoke
    from repro_torch.faults import RUNG_OVERLAP
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine, ServeConfig
    cfg = smoke(registry()["qwen3_4b"])
    eng = PagedServingEngine(cfg, init_params(cfg, device="cpu"),
                             ServeConfig(**{field: value}), device="cpu")
    if field == "qos":
        assert eng.batcher.priority_aware
        assert eng.memos.governor.budget_mw == 1.0
        assert eng.submit([1, 2], 2, tenant="lc").priority == 2
    else:
        assert eng.memos.cfg.async_plan
        assert eng.memos.ladder.top == eng.memos.ladder.rung == RUNG_OVERLAP
        assert eng.memos.ladder.rung_name == "overlap"
    eng.close()


def test_serve_config_refuses_pinned_tiers():
    """Pinned-host tiers are served (the dual-pool decode), and int8
    tiers — numpy host and pinned — are accepted by the config and the
    store, with prefill on; only a hierarchy with two int8 tiers is
    refused, by the store."""
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.core.tiers import (HostPool, PinnedHostPool,
                                        StoreConfig, TierStore)
    from repro_torch.serving.engine import ServeConfig
    ServeConfig(hierarchy=MemoryHierarchy.two_tier(8, 16, pinned_slow=True))
    for pinned, pool_cls in ((False, HostPool), (True, PinnedHostPool)):
        int8 = MemoryHierarchy.two_tier(8, 16, pinned_slow=pinned,
                                        quantize_slow=True)
        ServeConfig(hierarchy=int8, prefill=True)
        store = TierStore(StoreConfig(n_pages=4, page_shape=(2,),
                                      hierarchy=int8), device="cpu")
        pool = store.pools[1]
        assert isinstance(pool, pool_cls) and pool.quantized
        assert pool.data.dtype in (np.int8, torch.int8)
    two = MemoryHierarchy.three_tier(4, 8, 16, quantize_nvm=True).with_tier(
        1, residency="host", quantize_int8=True)
    with pytest.raises(NotImplementedError, match="more than one int8"):
        TierStore(StoreConfig(n_pages=4, page_shape=(2,), hierarchy=two),
                  device="cpu")


def test_pinned_tier_asks_for_pinned_memory_only_on_the_card():
    """A CPU store's pinned tier is a plain CPU tensor (there is no card
    to map it for); the kernels' plain versions serve it."""
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.core.tiers import PinnedHostPool, StoreConfig, TierStore
    store = TierStore(StoreConfig(
        n_pages=4, page_shape=(2,), hierarchy=MemoryHierarchy.two_tier(
            2, 4, pinned_slow=True)), device="cpu")
    pool = store.pools[1]
    assert isinstance(pool, PinnedHostPool)
    assert pool.data.device.type == "cpu" and not pool.data.is_pinned()
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="not pinned"):
        _build.device_address(pool.data)
