"""The float32 attention kernels of ``chip_smoke.py``'s kernels line, alone.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/f32_lines.py [LABEL]

It imports the ``chip_smoke.py`` beside it in the working directory and
prints one JSON line: LABEL, the card, and for each float32 shape of that
script the kernel's device ms per call over a CUDA graph of calls, its
largest error against the plain version, SDPA's float32 device ms on the
same inputs, and a SHA-256 of the kernel's output, so two trees' bits
compare by digest.  The shapes: K1's prefill body at the float32 prefill
probe's shape (one 128-token segment, 8-page tables) and at the engine's
bucket (two 128-token segments in 256 rows, 16-page tables), K1's decode
body at the engine's decode shape (batch 8, contexts 129-160), all at
qwen3_4b's widths (8 KV heads, G 4, D 128, page 16); K8 at the float32
long-context probe's shape (B 1, S 500) and at zamba2's prefill shape
(B 4, S 2000), 32/32 heads, D 112, causal.  Inputs are seeded random
values.  Two trees are compared by running it in each, interleaved, in
one call on one card.
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _k1_lines(cs) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as K1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 18)
    rng = np.random.RandomState(cs.SEED + 18)
    Hkv, G, D, page, slots = 8, 4, 128, 16, 64
    Hq = Hkv * G
    k_pool, v_pool = (torch.randn((slots, page, Hkv, D), generator=gen,
                                  device=dev) for _ in range(2))
    seg = 128
    seg_pages = rng.permutation(slots)[:2 * seg // page].reshape(2, -1)
    out = {}

    def line(fn, plain, lib):
        got = fn()
        err = float((got - plain()).abs().max())
        return {"device_ms": cs._graph_ms(fn),
                "max_abs_err": err,
                "sdpa_device_ms": cs._graph_ms(lib),
                "sha256": _digest(got)}

    for name, n_seg, P in (("k1_prefill_probe", 1, 8),
                           ("k1_prefill_bucket", 2, 16)):
        L = n_seg * seg
        tables = np.zeros((n_seg, P), np.int32)
        tables[:, :seg // page] = seg_pages[:n_seg]
        bt, lengths = cs._packed_bucket(
            [(i * seg, seg, tables[i]) for i in range(n_seg)], L, P)
        q = torch.randn((L, Hkv, G, D), generator=gen, device=dev) \
            * D ** -0.5
        args = (q, k_pool, v_pool, torch.from_numpy(bt).to(dev),
                torch.from_numpy(lengths).to(dev))
        flat = torch.from_numpy(seg_pages[:n_seg].reshape(-1)).to(dev).long()
        kc, vc = (t[flat].reshape(n_seg, seg, Hkv, D).transpose(1, 2)
                  .repeat_interleave(G, dim=1).contiguous()
                  for t in (k_pool, v_pool))
        q4 = q.reshape(n_seg, seg, Hq, D).transpose(1, 2).contiguous()
        out[name] = line(
            lambda: K1.paged_attention_prefill_pooled(*args),
            lambda: K1.paged_attention_plain(*args),
            lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                   is_causal=True, scale=1.0))
    B, P = 8, 16
    lengths = rng.randint(129, 161, size=B).astype(np.int32)
    bt = np.stack([rng.permutation(slots)[:P] for _ in range(B)]).astype(
        np.int32)
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev) * D ** -0.5
    tbt, tl = torch.from_numpy(bt).to(dev), torch.from_numpy(lengths).to(dev)
    args = (q, k_pool, v_pool, tbt, tl)
    S = P * page
    kc, vc = (t[tbt.long()].reshape(B, S, Hkv, D).transpose(1, 2)
              .repeat_interleave(G, dim=1).contiguous()
              for t in (k_pool, v_pool))
    q4 = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(S, device=dev)[None, :] < tl[:, None])[:, None,
                                                                 None, :]
    out["k1_decode"] = line(
        lambda: K1.paged_attention_pooled(*args),
        lambda: K1.paged_attention_plain(*args),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                               scale=1.0))
    return out


def _k8_lines(cs) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 19)
    out = {}
    for name, B, S in (("k8_probe", 1, cs.LONGCTX_PROBE_PROMPT),
                       ("k8_zamba2", cs.LONGCTX_BATCH, cs.LONGCTX_PROMPT)):
        q, k, v = (torch.randn((B, S, 32, 112), generator=gen, device=dev)
                   for _ in range(3))
        got = K8.flash_attention(q, k, v)
        err = float((got - K8.flash_attention_plain(q, k, v)).abs().max())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out[name] = {
            "device_ms": cs._graph_ms(lambda: K8.flash_attention(q, k, v),
                                      calls=10, replays=10),
            "max_abs_err": err,
            "sdpa_device_ms": cs._graph_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                calls=10, replays=10),
            "sha256": _digest(got)}
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("f32_lines: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"f32_lines: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    line = {"label": argv[0] if argv else str(root), "card": cs._card_line(),
            **_k1_lines(cs), **_k8_lines(cs)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
