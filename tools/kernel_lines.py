"""Device times of the decode's KV append stage and of K6, and the device
operations per decode inner step, in the tree it runs from.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/kernel_lines.py [--k6-only] [LABEL]

It imports the ``chip_smoke.py`` beside it in the working directory and
prints one JSON line: LABEL, the card, and

* ``ops_per_inner_step``: ``chip_smoke.run_profiled_window`` over the
  host tier and the pinned tier (qwen3_4b at full width and depth,
  bf16): device records per decode inner step and the busy share;
* ``append_stage``: a CUDA graph of one layer's work from the raw q/k/v
  projections to the q the paged attention reads and the K/V rows in
  the pools, as the tree runs it — ``attention.rope_append`` (one
  ``qkv_rope_append`` launch) where the tree has it, else the eager qk-norm, RoPE and q scaling followed by the
  append (two ``index_put_`` on one pool, the ``kv_append`` kernel on
  two pools or a prefill bucket) — at the decode's 8 rows over one pool
  and over two (half the rows to pinned host memory) and at a 256-row
  prefill bucket: device ms per call and device work nodes per call;
* ``page_gather_quant``: K6 over 16 pages of the engine's 2.36 MB page
  shape from HBM in bf16 and float32 and from pinned host memory in
  bf16: device ms per call over a CUDA graph, eager ms, device work
  nodes per call and a SHA-256 of (q, scale), so two trees' bits
  compare; and ``hbm_bf16_by_pages``, the device ms of 1 to 32 bf16
  pages from HBM (how the time grows with the pages of a call).

With ``--k6-only`` it measures ``page_gather_quant`` alone.  Two trees
are compared by running it in each, interleaved, in one call on one
card.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path


def _append_stage(cfg, params, cs) -> dict:
    import torch
    from repro_torch.kernels import kv_append as KA
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    fused = hasattr(A, "rope_append")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ap = params["layers"][0]["attn"]
    page, slots, l = 16, 16, 0
    shape = (slots, cfg.n_layers, 2, page, Hkv, D)
    fast = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    pin = torch.empty(shape, dtype=torch.bfloat16, pin_memory=True)
    pin.copy_(fast)

    def case(R, pinned):
        def rows(H):
            return torch.randn((R, H, D), generator=gen, device=dev).to(
                torch.bfloat16)
        q, k, v = rows(Hq), rows(Hkv), rows(Hkv)
        pos = torch.arange(R, device=dev, dtype=torch.int32)[:, None] % 128
        cos, sin = (t[:, 0] for t in L.rope_angles(pos, D, cfg.rope_theta))
        at = torch.randperm(slots * page, generator=gen, device=dev)[:R]
        slot, off = (at // page).int(), (at % page).int()
        to_pin = (torch.arange(R, device=dev) % 2 == 1) & pinned
        f_idx = torch.where(to_pin, slots, slot).int()
        p_idx = torch.where(to_pin, slot, slots).int()
        rows_l, off_l = slot.long(), off.long()
        qn, kn = ap.get("q_norm"), ap.get("k_norm")

        def call():
            if fused:
                return A.rope_append(
                    q, k, v, qn, kn, cos, sin, fast[:, l],
                    pin[:, l] if pinned else None, f_idx,
                    p_idx if pinned else None, off)
            qq, kk = q, k
            if qn is not None:
                qq, kk = L.rms_norm(qq, qn), L.rms_norm(kk, kn)
            qq, kk = L.apply_rope(qq, cos, sin), L.apply_rope(kk, cos, sin)
            if pinned or R > 8:       # the parent's kv_append kernel
                KA.kv_append(fast[:, l], pin[:, l] if pinned else None,
                             f_idx, p_idx if pinned else None, off, kk, v)
            else:                     # the parent's single-pool decode
                fast[rows_l, l, 0, off_l] = kk
                fast[rows_l, l, 1, off_l] = v
            return (qq * D ** -0.5).reshape(R, Hkv, Hq // Hkv, D)
        return {"device_ms": cs._graph_ms(call),
                "device_nodes_per_call": cs._graph_launches(call)}
    return {"fused": fused, "decode_one_pool": case(8, False),
            "decode_two_pools": case(8, True),
            "prefill_bucket_256": case(256, False)}


def _k6(cs) -> dict:
    import torch
    from repro_torch.kernels import page_quant as K6
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 12)
    page = (36, 2, 16, 8, 128)
    out = {}
    for name, dtype, slots, pinned in (("hbm_bf16", torch.bfloat16, 64, False),
                                       ("hbm_f32", torch.float32, 32, False),
                                       ("pinned_bf16", torch.bfloat16, 32,
                                        True)):
        pool = (torch.randn((slots, *page), generator=gen, device=dev) * 3
                ).to(dtype)
        if pinned:
            pool = pool.cpu().pin_memory()
        idx = torch.randperm(slots, generator=gen, device=dev)[:16].int()
        q, s = K6.page_gather_quant(pool, idx)
        torch.cuda.synchronize()
        digest = hashlib.sha256(q.cpu().numpy().tobytes()
                                + s.cpu().numpy().tobytes()).hexdigest()
        out[name] = {
            "device_ms": cs._graph_ms(lambda: K6.page_gather_quant(pool, idx)),
            "ms": cs._time_ms(lambda: K6.page_gather_quant(pool, idx)),
            "device_nodes_per_call": cs._graph_launches(
                lambda: K6.page_gather_quant(pool, idx)),
            "sha256": digest}
        if name == "hbm_bf16":
            out["hbm_bf16_by_pages"] = {}
            for k in (1, 2, 4, 7, 8, 14, 16, 32):
                ik = torch.randperm(slots, generator=gen, device=dev)[:k]
                ik = ik.int()
                out["hbm_bf16_by_pages"][k] = cs._graph_ms(
                    lambda: K6.page_gather_quant(pool, ik))
        del pool
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_lines: no CUDA device", file=sys.stderr)
        return 2
    k6_only = "--k6-only" in argv
    argv = [a for a in argv if a != "--k6-only"]
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"kernel_lines: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.configs.base import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    out = {"label": argv[0] if argv else str(root), "card": cs._card_line()}
    if not k6_only:
        cfg = registry()["qwen3_4b"]
        params = init_params(cfg, seed=cs.SEED, dtype=torch.bfloat16,
                             device="cuda")
        out["ops_per_inner_step"] = {}
        for pinned in (False, True):
            w = cs.run_profiled_window(cfg, params, pinned=pinned)
            out["ops_per_inner_step"][w["phase"]] = {
                "inner_steps": w["inner_steps"],
                "device_events": w["device_events"],
                "ops_per_inner_step": w["device_events"] / max(
                    sum(w["inner_steps"]), 1),
                "device_busy_share": w["device_busy_share"]}
        out["append_stage"] = _append_stage(cfg, params, cs)
        del params
        torch.cuda.empty_cache()
    out["page_gather_quant"] = _k6(cs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
