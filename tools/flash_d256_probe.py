"""bf16 K8 past D 128 on a card: the streaming floor and the variants.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/flash_d256_probe.py [LABEL]

It builds ``tools/flash_d256_probe.cu`` (which includes the port's
``csrc/flash_attention.cu``) with ``nvcc`` and the port's flags into the
kernels' build directory, imports the ``chip_smoke.py`` beside it in the
working directory for its timers, and prints one JSON line: LABEL, the
card, and

- ``stream``: the earlier D-256 design's TMA pattern with no math
  (``probe_stream``) at gemma3_4b's shapes (B 4, S 2000, 8/4 heads,
  D 256; causal and the 1024-token window), in clusters of one and two
  CTAs: device ms per call over a CUDA graph of 10 calls, the bytes
  written into shared memory and read from L2 (a pair in a cluster reads
  a tile once), and their rates in TB/s;
- ``variants``: the library's entry and each plan of ``flash_d256_kernel``
  (keys a tile, K and V stages, the in-warpgroup pipeline, the warpgroup
  ping-pong, the folded exponent, and the library's plan with parts left
  out) at both shapes, persistent (one CTA an SM) and one work item a
  CTA, timed in two rounds in one process, the second in the reverse
  order: device ms of each round, the largest error against the plain
  version and a SHA-256 of the output (variant 0, the library's plan, must
  give the entry's bits); then every plan against the plain version at
  small shapes (D 136 and 256; G 1, 2, 3; ragged S, ``seq_len`` < S,
  windows that cut a tile, non-causal), on the entry's grid and on two
  CTAs that walk every item, within K8's bf16 tolerance, 1e-2;
- ``sass``: each plan's HGMMA, spills and highest register;
- ``ptxas``: each variant's registers, spills and any ptxas warning.

It exits 1 if a variant disagrees with the plain version or variant 0
with the entry.  ``chip_smoke.py`` calls ``build`` and ``stream`` for the
streaming times of its K8 rows.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

TOL = 1e-2
SHAPES = (("gemma3_global", 0), ("gemma3_window", 1024))   # B 4, S 2000
SMALL = (
    # B, S, Hq, Hkv, D, causal, window, seq_len
    (2, 128, 8, 4, 256, True, 0, None),
    (1, 300, 8, 4, 136, True, 70, None),
    (2, 200, 4, 1, 256, True, 0, 150),
    (1, 97, 4, 4, 256, False, 0, None),
    (1, 260, 6, 2, 256, False, 40, 230),
    (1, 333, 6, 2, 136, True, 100, None),
    (1, 517, 4, 2, 256, True, 0, 400),
)


def build(root: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``tools/flash_d256_probe.cu`` under ``root`` into the
    kernels' build directory; the library and ptxas's report."""
    from repro_torch.kernels import _build as B
    out = B.BUILD_DIR / "libflash_d256_probe.so"
    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    run = subprocess.run(
        [B.nvcc(), *B.NVCC_FLAGS, "-shared", "-I", str(B.CSRC), "-o",
         str(out), str(root / "tools" / "flash_d256_probe.cu")],
        capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}\n{run.stderr}")
    lib = ctypes.CDLL(str(out))
    c, i, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [c] * 4 + [i] * 9 + [ctypes.c_float] + [L] * 9 + [c]
    lib.probe_wide.argtypes = args + [i, i]
    lib.probe_stream.argtypes = args + [i]
    lib.probe_plan.argtypes = [i, ctypes.POINTER(i)]
    for fn in (lib.probe_wide, lib.probe_stream, lib.probe_plan,
               lib.probe_variants):
        fn.restype = i
    return lib, run.stdout + run.stderr


def _call(fn, q, k, v, out, causal, window, seq_len, *extra) -> None:
    """``fn`` (a probe entry with the port's flash arguments) on q, k, v
    [B, S, H, D] bf16 on the card, writing ``out``."""
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import flash_attention as K8
    Bq, Sq, Hq, D = q.shape
    qs, ks, vs = (K8.tma_strides(t, n) for n, t in
                  (("q", q), ("k", k), ("v", v)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if out is None else out.data_ptr(), Bq, Sq, k.shape[1],
             Hq, k.shape[2], D, k.shape[1] if seq_len is None else seq_len,
             int(causal), window, D ** -0.5, *qs, *ks, *vs,
             B.current_stream(q.device.index), *extra)
    B.check(err, fn.__name__)


def stream(lib: ctypes.CDLL, q, k, v, *, window: int = 0,
           cluster: int = 1) -> None:
    """Stream the K/V tiles of the earlier D-256 design (causal, 128 q
    rows a CTA, 64-key tiles) into shared memory with no math, in
    clusters of ``cluster`` CTAs (2: q heads 2j and 2j + 1 read each tile
    from L2 once, by multicast; G must be even).  It writes nothing and
    counts no launch."""
    _call(lib.probe_stream, q, k, v, None, True, window, None, cluster)


def _plan_name(mangled: str) -> str | None:
    """A short name for a flash_d256_kernel instantiation: keys a tile, K
    and V stages, pipeline, ping-pong, fold and parts left out."""
    w = re.search(r"variant_kernel.*WideILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)"
                  r"ELb(\d)ELb(\d)ELi(\d+)E", mangled)
    return (f"bk{w[1]}_k{w[2]}_v{w[3]}_pipe{w[4]}_pp{w[5]}_f{w[6]}_ab{w[7]}"
            if w else None)


def _ptxas(log: str) -> dict:
    """Registers and spills of each compiled flash_d256_kernel plan and
    every ptxas warning."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            name = _plan_name(fn)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
    out["warnings"] = [ln for ln in log.splitlines() if "arning" in ln]
    return out


def _sass(lib_path: str) -> dict:
    """Per compiled flash_d256_kernel plan, from ``cuobjdump -sass``:
    HGMMA, spill stores and loads (STL, LDL), those spills between the
    first and the last HGMMA (the tile loop), and the highest register
    index used."""
    from repro_torch.kernels import _build as B
    tool = Path(B.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, ops, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _plan_name(m[1])
            if name:
                out[name] = {"HGMMA": 0, "STL": 0, "LDL": 0, "max_reg": 0}
                ops[name] = []
            continue
        if name:
            for op in ("HGMMA", "STL", "LDL"):
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
                    ops[name].append(op)
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                out[name]["max_reg"] = max(out[name]["max_reg"], max(regs))
    for name, seq in ops.items():
        g = [i for i, op in enumerate(seq) if op == "HGMMA"]
        out[name]["spills_in_loop"] = sum(
            1 for i, op in enumerate(seq)
            if op != "HGMMA" and g and g[0] < i < g[-1])
    return out


def _tiles(B, S, Hq, window, kbk=64, bq=128) -> int:
    """K/V tiles the bf16 entry's grid streams (each CTA its key range)."""
    n = 0
    for q0 in range(0, S, bq):
        lo = max(0, q0 - window + 1) // kbk * kbk if window else 0
        hi = min(S, q0 + bq)
        n += -(-(hi - lo) // kbk)
    return n * B * Hq


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_d256_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"flash_d256_probe: no chip_smoke.py in {root}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import _build as B
    from repro_torch.kernels import flash_attention as K8
    B.library()
    lib, log = build(root)
    n_var = lib.probe_variants()
    dev = torch.device("cuda")

    def plan(n):
        info = (ctypes.c_int * 8)()
        B.check(lib.probe_plan(n, info), "probe_plan")
        return {"keys": info[0], "k_stages": info[1], "v_stages": info[2],
                "smem_bytes": info[3], "pipeline": bool(info[4]),
                "ping_pong": bool(info[5]), "ablate": info[6],
                "fold": bool(info[7])}

    def digest(t):
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()

    plans = {n: plan(n) for n in range(n_var)}
    line = {"label": argv[0] if argv else str(root),
            "card": cs._card_line(), "ptxas": _ptxas(log),
            "sass": _sass(lib._name),
            "plans": plans,
            "entry_plan": K8.wide_launch_info(4, 2000, 8),
            "stream": {}, "variants": {}, "small": {}}
    ok = True
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 31)
    Bn, S, Hq, Hkv, D = 4, 2000, 8, 4, 256
    q, k, v = (torch.randn((Bn, S, h, D), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    out = torch.empty_like(q)
    items = Bn * Hq * -(-S // 128)
    for name, window in SHAPES:
        tiles = _tiles(Bn, S, Hq, window)
        q_bytes = items * 65536                 # each CTA its own Q
        for cl in (1, 2):
            smem_bytes = tiles * 65536 + q_bytes
            l2_bytes = tiles * 65536 / cl + q_bytes
            ms = cs._graph_ms(lambda: stream(lib, q, k, v, window=window,
                                             cluster=cl),
                              calls=10, replays=10)
            line["stream"][f"{name}_cluster{cl}"] = {
                "device_ms": ms, "tiles": tiles,
                "smem_bytes": smem_bytes, "l2_bytes": l2_bytes,
                "smem_tb_s": smem_bytes / ms / 1e9,
                "l2_tb_s": l2_bytes / ms / 1e9}
        ref = K8.flash_attention_plain(q, k, v, window=window)
        entry = K8.flash_attention(q, k, v, window=window)
        line["variants"][f"{name}_entry"] = {
            "device_ms": [],
            "max_abs_err": float((entry.float() - ref.float()).abs().max()),
            "sha256": digest(entry)}
        runs = [("entry", None, None)] + [
            (f"v{n}" + ("_one_item" if ctas else ""), n, ctas)
            for n in range(n_var) for ctas in (0, items)]
        for run, n, ctas in runs[1:]:           # check each once
            key = f"{name}_{run}"
            print(key, file=sys.stderr, flush=True)
            try:
                _call(lib.probe_wide, q, k, v, out, True, window, None, n,
                      ctas)
                torch.cuda.synchronize()
            except RuntimeError as e:
                line["variants"][key] = {"error": str(e)}
                ok = False
                continue
            if not plans[n]["ablate"]:
                ok &= torch.allclose(out.float(), ref.float(), atol=TOL,
                                     rtol=TOL)
            line["variants"][key] = {
                "device_ms": [],
                "max_abs_err": float((out.float() - ref.float()).abs()
                                     .max()),
                "sha256": digest(out)}
        same = (line["variants"][f"{name}_v0"]["sha256"]
                == line["variants"][f"{name}_entry"]["sha256"])
        line["variants"][f"{name}_v0"]["equals_entry"] = same
        ok &= same
        for order in (runs, runs[::-1]):        # two rounds, then reversed
            for run, n, ctas in order:
                rec = line["variants"].get(f"{name}_{run}")
                if rec is None or "error" in rec:
                    continue
                if n is None:
                    fn = lambda: K8.flash_attention(q, k, v, window=window)
                else:
                    fn = (lambda n=n, ctas=ctas: _call(
                        lib.probe_wide, q, k, v, out, True, window, None, n,
                        ctas))
                rec["device_ms"].append(cs._graph_ms(fn, calls=10,
                                                     replays=10))
        del ref, entry
    del q, k, v, out
    torch.cuda.empty_cache()
    for case in SMALL:
        Bs, Ss, Hqs, Hkvs, Ds, causal, window, seq_len = case
        gen.manual_seed(Ds + Ss)
        q, k, v = (torch.randn((Bs, Ss, h, Ds), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hqs, Hkvs, Hkvs))
        ref = K8.flash_attention_plain(q, k, v, causal=causal,
                                       window=window, seq_len=seq_len)
        errs = {}
        for n in range(n_var):
            if plans[n]["ablate"]:
                continue
            for ctas in (0, 2):         # 2: many items a CTA
                print(case, n, ctas, file=sys.stderr, flush=True)
                out = torch.full_like(q, float("nan"))
                _call(lib.probe_wide, q, k, v, out, causal, window, seq_len,
                      n, ctas)
                torch.cuda.synchronize()
                errs[f"{n}_{ctas}"] = float((out.float() - ref.float())
                                            .abs().max())
                ok &= torch.allclose(out.float(), ref.float(), atol=TOL,
                                     rtol=TOL)
        line["small"][str(case)] = errs
    line["ok"] = bool(ok)
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
