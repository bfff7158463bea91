#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full qwen3_4b, no arguments

Phases (each raises on failure; the script then exits non-zero and
prints no result line):

  1. build every CUDA kernel of the serving path from ``csrc/`` (nvcc,
     one process per source, started together);
  2. serve requests through ``PagedServingEngine`` — fused K-step decode
     over the two-tier HBM -> host ``TierStore`` with memos on — at the
     full published width of qwen3_4b in bfloat16, with random weights
     drawn on the card from a seed.  The HBM pool is smaller than the
     batch's demand, so preemption, demotion, promotion and slow-tier
     wear all happen; the kernel launch counts are read around this run;
  3. fused dispatch vs the K=1 reference path at the same width, memos
     off: the generated tokens, SysMon counters and page versions must
     be identical;
  4. two fused dispatches under ``torch.profiler``: the device's busy
     share of the wall time;
  5. a small float32 model stepped on the card and on the CPU (the plain
     kernel versions): logits within 1e-3 and identical integer state;
  6. every kernel against its plain PyTorch version on the card at the
     shapes the engine gave it (bf16 attention within atol = rtol = 3e-3,
     a limit a bf16-accumulating kernel body must fail; the integer
     kernels exactly), with CUDA-event timings of the
     kernel, the plain version and one PyTorch library call, and the
     least time the card could take (bytes over 3.35 TB/s, operations
     over the bf16 peak).

Output: the card's name and power limit, the build time, the engine
line, the parity lines, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Exits 2 without a CUDA device and 1
when the port's sources are not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
# bf16 K/V, kernel vs plain, atol = rtol: ~3x the kernel's error on the
# card, below what accumulating softmax.V in bf16 gives (checked per run)
ATTN_TOL = 3e-3

SEED = 0
REQUESTS, PROMPT_LEN, NEW_TOKENS = 12, 128, 32       # the engine run
PARITY_PROMPT_LEN, PARITY_NEW_TOKENS = 32, 16        # the parity runs


def _emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: bytes moved over the memory
    rate, or operations on the bf16 inputs over the card's bf16 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# =============================================================================
# phase 2-3: the engine at full width
# =============================================================================

def _serve_config(**kw):
    from repro_torch.serving.engine import ServeConfig
    base = dict(page_size=16, max_batch=8, fast_slots=64, slow_slots=512,
                max_pages_per_seq=16, memos_interval=8, decode_block=8)
    base.update(kw)
    return ServeConfig(**base)


def _prompts(n: int, length: int, vocab: int, seed: int) -> list[list[int]]:
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=length).tolist() for _ in range(n)]


def run_engine(cfg, params) -> tuple[dict, dict, object]:
    import torch
    from repro_torch import kernels, obs
    from repro_torch.models.transformer import pad_vocab
    from repro_torch.serving.engine import PagedServingEngine
    eng = PagedServingEngine(cfg, params, _serve_config(), device="cuda")
    prompts = _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    obs.configure(trace=True)      # the engine's own spans: where time goes
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    obs.configure(trace=False)
    span_s: dict[str, float] = {}
    for ev in obs.get_tracer().events():
        span_s[ev.name] = span_s.get(ev.name, 0.0) + ev.dur_ns * 1e-9
    store = eng.kv.store
    mig = eng.memos.engine.stats
    wear = store.wear
    out = {
        "phase": "engine", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": "bfloat16",
        "requests": len(reqs), "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS,
        "generated": eng.tokens_out,
        "processed_tokens": int(sum(len(r.tokens) for r in reqs)),
        "seconds": dt,
        "generated_tokens_per_s": eng.tokens_out / dt,
        "processed_tokens_per_s": sum(len(r.tokens) for r in reqs) / dt,
        "steps": len(hist), "dispatches": len(hist),
        "memos_passes": len(eng.memos.reports),
        "migrations_to_fast": mig.to_fast, "migrations_to_slow": mig.to_slow,
        "memos_pass_to_fast": sum(r.migrations.to_fast
                                  for r in eng.memos.reports),
        "memos_pass_to_slow": sum(r.migrations.to_slow
                                  for r in eng.memos.reports),
        "preemptions": eng.batcher.n_preempted,
        "traffic_0_1_bytes": store.traffic[(0, 1)],
        "traffic_1_0_bytes": store.traffic[(1, 0)],
        "slow_wear_max": wear.max_wear(),
        "slow_writes": wear.writes_total,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        # host wall seconds per span name (nested spans such as
        # migrate.move_group are also inside their parents)
        "span_seconds": span_s,
    }
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != NEW_TOKENS]
    if bad:
        raise RuntimeError(f"requests {bad} did not complete")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise RuntimeError("non-finite logits")
    if eng.last_logits.shape[-1] != pad_vocab(cfg.vocab):
        raise RuntimeError(f"logits shape {tuple(eng.last_logits.shape)}")
    for key in ("traffic_0_1_bytes", "traffic_1_0_bytes", "slow_wear_max",
                "slow_writes", "migrations_to_fast", "migrations_to_slow"):
        if not out[key]:
            raise RuntimeError(f"engine run has {key} == 0: the memos path "
                               f"did not run")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    return out, launches, eng


def run_fused_vs_reference(cfg, params) -> dict:
    import numpy as np
    import torch
    from repro_torch.serving.engine import PagedServingEngine
    prompts = _prompts(4, PARITY_PROMPT_LEN, cfg.vocab, SEED + 1)
    runs = {}
    for ref in (False, True):
        # memos off, as the JAX package pins this parity: no pass boundary
        # resets the counters, so they cover the whole access stream
        eng = PagedServingEngine(cfg, params,
                                 _serve_config(reference=ref,
                                               memos_enabled=False),
                                 device="cuda")
        reqs = [eng.submit(p, PARITY_NEW_TOKENS) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        state = {f: getattr(eng.sysmon, f).cpu().numpy()
                 for f in eng.sysmon._fields}
        state["version"] = eng.kv.store.version.copy()
        runs[ref] = ([r.generated for r in reqs], state)
    toks_f, sm_f = runs[False]
    toks_r, sm_r = runs[True]
    if toks_f != toks_r:
        raise RuntimeError(f"fused vs reference tokens differ: {toks_f} "
                           f"vs {toks_r}")
    diff = [f for f in sm_f if not np.array_equal(sm_f[f], sm_r[f])]
    if diff:
        raise RuntimeError(f"fused vs reference SysMon/versions differ "
                           f"in {diff}")
    return {"phase": "fused_vs_reference", "requests": 4,
            "prompt_len": PARITY_PROMPT_LEN,
            "new_tokens": PARITY_NEW_TOKENS, "tokens_identical": True,
            "sysmon_identical": True}


def run_profiled_window(cfg, params) -> dict:
    """Two fused dispatches of a fresh engine under ``torch.profiler``
    (device activity only): the device's busy share of the host wall
    time, from the union of the kernel and copy intervals it traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import PagedServingEngine
    scfg = _serve_config()
    eng = PagedServingEngine(cfg, params, scfg, device="cuda")
    for p in _prompts(scfg.max_batch, PARITY_PROMPT_LEN, cfg.vocab,
                      SEED + 3):
        eng.submit(p, PARITY_NEW_TOKENS)
    eng.step()                                  # admission, first dispatch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ks = [eng.step().get("decode_block", 0) for _ in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                  # union of possibly overlapping spans
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"phase": "profiled_window", "dispatches": 2, "inner_steps": ks,
            "batch": scfg.max_batch, "wall_s": wall,
            "device_events": len(spans), "device_busy_s": busy_us * 1e-6,
            "device_busy_share": busy_us * 1e-6 / wall if spans else None}


def run_card_vs_cpu() -> dict:
    """A small float32 engine stepped on the card and on the CPU from the
    same weights and prompts: the first dispatches' logits agree within
    1e-3 and the integer state matches exactly."""
    import numpy as np
    import torch
    from repro_torch.configs.base import registry, smoke
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine
    cfg = smoke(registry()["qwen3_4b"])
    params = init_params(cfg, seed=SEED, dtype=torch.float32,
                         device="cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    cpu_params = to_cpu(params)
    prompts = _prompts(3, 6, cfg.vocab, SEED + 2)
    engines = []
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        eng = PagedServingEngine(
            cfg, p, _serve_config(page_size=4, max_batch=3, fast_slots=8,
                                  slow_slots=64, max_pages_per_seq=8,
                                  memos_interval=2, reference=True),
            device=dev)
        for pr in prompts:
            eng.submit(pr, 4)
        engines.append(eng)
    max_err = 0.0
    for _ in range(3):        # prompt replay: identical inputs each step
        logits = []
        for eng in engines:
            eng.step()
            logits.append(eng.last_logits.float().cpu())
        max_err = max(max_err, float((logits[0] - logits[1]).abs().max()))
        if not torch.allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3):
            raise RuntimeError(f"card vs CPU logits differ by {max_err}")
    g, c = engines
    for f in g.sysmon._fields:
        if not np.array_equal(getattr(g.sysmon, f).cpu().numpy(),
                              getattr(c.sysmon, f).numpy()):
            raise RuntimeError(f"card vs CPU SysMon differs in {f}")
    if not (np.array_equal(g.kv.store.tier, c.kv.store.tier)
            and np.array_equal(g.kv.store.slot, c.kv.store.slot)):
        raise RuntimeError("card vs CPU page tables differ")
    return {"phase": "card_vs_cpu", "arch": cfg.name, "steps": 3,
            "logits_max_abs_err": max_err, "tolerance": 1e-3}


# =============================================================================
# phase 6: every kernel against its plain version
# =============================================================================

def _attn_bf16_accumulating(q, k_pool, v_pool, bt, lengths):
    """The plain attention with softmax.V summed page by page into a bf16
    accumulator: what a kernel body that accumulates in bf16 returns.
    ``ATTN_TOL`` must reject it."""
    import torch
    B, Hkv, G, D = q.shape
    page, P = k_pool.shape[1], bt.shape[1]
    k = k_pool[bt.long()].reshape(B, P * page, Hkv, D).float()
    v = v_pool[bt.long()].reshape(B, P * page, Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k)
    pos = torch.arange(P * page, device=q.device)
    s = s.masked_fill(pos >= lengths.long()[:, None, None, None], -1e30)
    pv = torch.einsum("bhgk,bkhd->bhgkd", torch.softmax(s, dim=-1), v)
    pv = pv.reshape(B, Hkv, G, P, page, D).sum(dim=4)
    acc = torch.zeros_like(q)
    for j in range(P):
        acc = (acc.float() + pv[:, :, :, j]).to(q.dtype)
    return acc


def bench_kernels(cfg, eng, launches: dict) -> list[dict]:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import hotness_update as K2
    from repro_torch.kernels import page_gather as K3
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import wear_update as K4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    scfg = eng.scfg
    store = eng.kv.store
    pool = store.fast_pool                       # [slots, L, 2, page, Hkv, D]
    n_slots, page = pool.shape[0], scfg.page_size
    B, P = scfg.max_batch, scfg.max_pages_per_seq
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    # refill the pool with random bf16 KV (the run freed every page)
    pool.copy_(torch.randn(pool.shape, generator=gen, device=dev,
                           dtype=torch.float32).to(pool.dtype))
    rows = []

    def row(name, src, replaces, err, ms, plain_ms, nbytes, flops,
            library_ms, tol):
        bound, by = _bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "tolerance": tol, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})

    # -- K1: one layer's attention, batch B, contexts the run reached -------
    k_pool, v_pool = pool[:, 0, 0], pool[:, 0, 1]
    ctx_max = PROMPT_LEN + NEW_TOKENS
    lengths_np = rng.randint(PROMPT_LEN + 1, ctx_max + 1, size=B)
    bt_np = np.stack([rng.permutation(n_slots)[:P] for _ in range(B)])
    bt = torch.from_numpy(bt_np.astype(np.int32)).to(dev)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    q = (torch.randn((B, Hkv, G, D), generator=gen, device=dev)
         * D ** -0.5).to(pool.dtype)
    out_k = K1.paged_attention_pooled(q, k_pool, v_pool, bt, lengths)
    out_p = K1.paged_attention_plain(q, k_pool, v_pool, bt, lengths)
    torch.cuda.synchronize()
    if not torch.allclose(out_k.float(), out_p.float(), atol=ATTN_TOL,
                          rtol=ATTN_TOL):
        raise RuntimeError("paged_attention kernel disagrees with plain")
    err = float((out_k.float() - out_p.float()).abs().max())
    foil = _attn_bf16_accumulating(q, k_pool, v_pool, bt, lengths).float()
    foil_err = float((foil - out_p.float()).abs().max())
    if torch.allclose(foil, out_p.float(), atol=ATTN_TOL, rtol=ATTN_TOL):
        raise RuntimeError(f"ATTN_TOL {ATTN_TOL} accepts a bf16-accumulating "
                           f"attention (max abs err {foil_err})")
    live = int(lengths_np.sum())
    nbytes = (2 * B * Hq * D * 2 + 2 * live * Hkv * D * 2
              + bt.numel() * 4 + B * 4)
    flops = 4.0 * Hq * D * live
    # yardstick: SDPA over the same KV gathered contiguous (not timed)
    S = P * page
    kc = k_pool[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vc = v_pool[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    kc = kc.repeat_interleave(G, dim=1)
    vc = vc.repeat_interleave(G, dim=1)
    q4 = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    row("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:75",
        err, _time_ms(lambda: K1.paged_attention_pooled(q, k_pool, v_pool, bt,
                                                   lengths)),
        _time_ms(lambda: K1.paged_attention_plain(q, k_pool, v_pool, bt,
                                                  lengths)),
        nbytes, flops,
        _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, scale=1.0)), ATTN_TOL)
    rows[-1]["bf16_accumulating_max_abs_err"] = foil_err

    # -- K2: the two samplings of an inner step: reads over B*P block-table
    # entries, then one write per sequence on its tail page -------------
    n_pages = eng.kv.n_pages
    ids = torch.from_numpy(rng.randint(0, n_pages, size=B * P)
                           .astype(np.int32)).to(dev)
    r = torch.from_numpy((rng.rand(B * P) < 0.7).astype(np.int32)).to(dev)
    w = torch.zeros_like(r)
    tail = torch.from_numpy(rng.permutation(n_pages)[:B].astype(np.int32)
                            ).to(dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    for sample in ((ids, r, w), (tail, torch.zeros_like(ones), ones)):
        got = K2.touch_update_events(n_pages, *sample)
        want = K2.touch_update_plain(n_pages, *sample)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("touch_update kernel disagrees with plain")
    z = torch.zeros(n_pages, dtype=torch.int32, device=dev)
    row("touch_update", "src/repro_torch/kernels/csrc/touch_update.cu",
        "src/repro/kernels/hotness_update/hotness_update.py:118", 0,
        _time_ms(lambda: K2.touch_update_events(n_pages, ids, r, w)),
        _time_ms(lambda: K2.touch_update_plain(n_pages, ids, r, w)),
        3 * ids.numel() * 4 + 3 * n_pages * 4, 0.0,
        _time_ms(lambda: z.index_add_(0, ids, r)), 0)

    # -- K3: a demotion-sized batch (pow2-padded) of whole KV pages --------
    k_mig = 16
    idx_np = rng.permutation(n_slots)[:k_mig - 2]
    idx_np = np.concatenate([idx_np, idx_np[-1:], idx_np[-1:]])
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    page_bytes = pool[0].numel() * pool.element_size()
    n_unique = len(np.unique(idx_np))    # the repeats move no new page
    staged = K3.page_gather(pool, idx)
    plain = K3.page_gather_plain(pool, idx)
    torch.cuda.synchronize()
    if not torch.equal(staged, plain):
        raise RuntimeError("page_gather kernel disagrees with plain")
    row("page_gather", "src/repro_torch/kernels/csrc/page_gather.cu",
        "src/repro/kernels/page_gather/page_gather.py:32", 0,
        _time_ms(lambda: K3.page_gather(pool, idx)),
        _time_ms(lambda: K3.page_gather_plain(pool, idx)),
        (n_unique + k_mig) * page_bytes + k_mig * 4, 0.0,
        _time_ms(lambda: pool.index_select(0, idx)), 0)
    # scatter into a scratch copy so the engine's pool stays intact
    target = pool.clone()
    want_pool = pool.clone()
    pages = torch.randn(staged.shape, generator=gen, device=dev).to(
        pool.dtype)
    pages[-2:] = pages[k_mig - 3]          # the pow2 repeats carry one page
    K3.page_scatter(target, idx, pages)
    K3.page_scatter_plain(want_pool, idx, pages)
    torch.cuda.synchronize()
    if not torch.equal(target, want_pool):
        raise RuntimeError("page_scatter kernel disagrees with plain")
    idx64 = idx.long()
    row("page_scatter", "src/repro_torch/kernels/csrc/page_gather.cu",
        "src/repro/kernels/page_gather/page_gather.py:53", 0,
        _time_ms(lambda: K3.page_scatter(target, idx, pages)),
        _time_ms(lambda: K3.page_scatter_plain(target, idx, pages)),
        2 * n_unique * page_bytes + k_mig * 4, 0.0,
        _time_ms(lambda: target.index_copy_(0, idx64, pages)), 0)
    del target, want_pool

    # -- K4: one flush of 128 bucketed wear events -------------------------
    n_slow = store.wear.n_slots
    wid = torch.from_numpy(rng.randint(0, n_slow, size=128)
                           .astype(np.int32)).to(dev)
    amt = torch.from_numpy(rng.randint(0, 4, size=128)
                           .astype(np.int32)).to(dev)
    base = torch.from_numpy(rng.randint(0, 100, size=n_slow)
                            .astype(np.int32)).to(dev)
    got = K4.wear_update_events(base.clone(), wid, amt)
    want = K4.wear_update_plain(base.clone(), wid, amt)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("wear_update kernel disagrees with plain")
    wbuf = base.clone()
    row("wear_update", "src/repro_torch/kernels/csrc/wear_update.cu",
        "src/repro/kernels/wear_update/wear_update.py:39", 0,
        _time_ms(lambda: K4.wear_update_events(wbuf, wid, amt)),
        _time_ms(lambda: K4.wear_update_plain(wbuf, wid, amt)),
        2 * n_slow * 4 + 2 * wid.numel() * 4, 0.0,
        _time_ms(lambda: wbuf.index_add_(0, wid, amt)), 0)
    return rows


# =============================================================================

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs.base import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [_card_line()]

    t0 = time.perf_counter()
    _build.library()
    lines.append({"phase": "build", "seconds": time.perf_counter() - t0,
                  "nvcc_seconds": _build.build_info.get("seconds")})
    print(_build.build_info.get("ptxas", ""), file=sys.stderr, flush=True)

    cfg = registry()["qwen3_4b"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init_params: {init_s:.1f} s", file=sys.stderr, flush=True)

    engine_line, launches, eng = run_engine(cfg, params)
    engine_line["init_params_s"] = init_s
    print(json.dumps(engine_line), file=sys.stderr, flush=True)
    parity = run_fused_vs_reference(cfg, params)
    print(json.dumps(parity), file=sys.stderr, flush=True)
    window = run_profiled_window(cfg, params)
    print(json.dumps(window), file=sys.stderr, flush=True)
    cross = run_card_vs_cpu()
    print(json.dumps(cross), file=sys.stderr, flush=True)
    kernel_rows = bench_kernels(cfg, eng, launches)

    lines += [{"kernels": kernel_rows}, engine_line, parity, window, cross,
              _card_line()]
    for line in lines:
        _emit(line)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
