"""Generated tokens/s of ``chip_smoke.py``'s serving runs, without the rest.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/engine_lines.py [LABEL]

It imports the ``chip_smoke.py`` beside it in the working directory and
runs that tree's serving phases at full qwen3_4b width and depth: the
host tier, the pinned tier under its media storm, prefill over the host
and pinned tiers, and the int8 host and pinned tiers.  It prints one
JSON line: LABEL, the card, the host microseconds per call of K1's
decode wrappers over the pinned engine's pools (one row, one page), and
per phase the generated tokens/s, TTFT p50 where the phase has one, and
the seconds of its dispatch, admission and memos spans.  Two trees are compared by running it in each,
interleaved, in one call on one card; run-to-run spread comes from the
host, so several interleaved pairs are needed.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def _k1_host_us(cfg, peng, host_us) -> dict:
    """Host microseconds per call of K1's decode wrappers over the pinned
    engine's pools, one row of one page, so the card finishes each call
    before the host issues the next: the wrapper's checks and launch."""
    import torch
    from repro_torch.kernels import paged_attention as K1
    store = peng.kv.store
    fast, pin = store.fast_pool, store.pools[peng.pinned_tier].data
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    P = peng.scfg.max_pages_per_seq
    q = torch.zeros((1, Hkv, cfg.n_heads // Hkv, D), dtype=fast.dtype,
                    device="cuda")
    bt = torch.zeros((1, P), dtype=torch.int32, device="cuda")
    sel = torch.ones((1, P), dtype=torch.int32, device="cuda")
    lengths = torch.full((1,), peng.scfg.page_size, dtype=torch.int32,
                         device="cuda")
    kf, vf, kp, vp = fast[:, 0, 0], fast[:, 0, 1], pin[:, 0, 0], pin[:, 0, 1]
    return {"paged_attention": host_us(
                lambda: K1.paged_attention_pooled(q, kf, vf, bt, lengths)),
            "paged_attention_dual": host_us(
                lambda: K1.paged_attention_dual_pooled(q, kf, vf, kp, vp, bt,
                                                       sel, lengths))}


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("engine_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"engine_lines: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.configs.base import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    cfg = registry()["qwen3_4b"]
    params = init_params(cfg, seed=cs.SEED, dtype=torch.bfloat16,
                         device="cuda")
    engine, _, _, tokens = cs.run_engine(cfg, params)
    pinned, _, peng = cs.run_engine_pinned(cfg, params, tokens)
    host_us = _k1_host_us(cfg, peng, cs._host_us)
    del peng
    pre, _, pre_tokens = cs.run_prefill(cfg, params, tokens)
    ppre, _ = cs.run_prefill_pinned(cfg, params, pre_tokens)
    i8h, _, i8p, _, _ = cs.run_int8(cfg, params, pre_tokens)
    spans = ("serve.dispatch", "serve.admit", "serve.provision",
             "memos.pass_sync")
    out = {"label": argv[0] if argv else str(root), "card": cs._card_line(),
           "k1_host_us": host_us}
    for line in (engine, pinned, pre, ppre, i8h, i8p):
        out[line["phase"]] = {
            "generated_tokens_per_s": line["generated_tokens_per_s"],
            "ttft_s_p50": line.get("ttft_s_p50"),
            "span_seconds": {k: line.get("span_seconds", {}).get(k)
                             for k in spans}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
