"""``moe_ffn_bwd``'s weight gradients on a card: the two dW routes and
what ``wgmma`` does with TF32 operands.

Run on a card from the root of a checkout (or of an unpacked archive of
one):

    python3 tools/moe_bwd_probe.py [LABEL]

It builds ``tools/moe_bwd_probe.cu`` (which includes the port's
``csrc/moe_ffn_bwd.cu``) with ``nvcc`` and the port's flags into the
kernels' build directory, imports the ``chip_smoke.py`` beside it in the
working directory for its inputs and timers, and prints one JSON line:
LABEL, the card, and

- ``wgmma_tf32``: c0 + x . 1 through one ``wgmma.m64n128k8`` TF32
  (x with bits below TF32's 10 mantissa bits: read truncated, rounded or
  whole; 1 + 0.75 ulp(1): the float32 sum rounded toward zero or to
  nearest), as ``tools/mma_tf32_probe.cu`` asks ``mma.sync``;
- ``wgmma_rate``: the TF32 rate of the consumers' pattern on every SM
  (two warpgroups issuing a stage's 12 ``wgmma.m64n128k8`` from a fixed
  tile), with the kernel's per-stage sums and as one chain: the
  ceiling a stage's loads and splits leave room under;
- ``routes``: at olmoe's training shape (2048 tokens x top 8 = 16384
  rows over 64 experts, d 2048, ff 1024, seeded as ``chip_smoke.py``'s
  ``moe_ffn_bwd`` row) the three weight gradients by the shipped route
  (``moe_ffn_bwd_f32`` kind 2: ``wgmma`` from the transposed [ff, R]
  intermediates, which ``torch`` transposes here) and by the
  ``mma.sync`` route (``probe_dw_mma``: row-major intermediates, each
  stage split once in shared memory), timed with CUDA events in the
  order mma, wgmma, wgmma, mma (10 calls each), with each route's
  largest error against a float64 product over each product's largest
  magnitude (``MOE_BWD_TOL``, 1e-5), the empty experts' dW exactly zero,
  the achieved 3xTF32 TFLOP/s (6 R d ff operations) and a SHA-256 of
  the outputs;
- ``ptxas``: registers and spills of every kernel in the probe library.

It exits 1 if a route misses 1e-5 or leaves an empty expert's dW
nonzero.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

TOL = 1e-5


def build(root: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``tools/moe_bwd_probe.cu`` under ``root`` into the kernels'
    build directory; the library and ptxas's report."""
    from repro_torch.kernels import _build as B
    out = B.BUILD_DIR / "libmoe_bwd_probe.so"
    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    run = subprocess.run(
        [B.nvcc(), *B.NVCC_FLAGS, "-shared", "-I", str(B.CSRC), "-o",
         str(out), str(root / "tools" / "moe_bwd_probe.cu")],
        capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}\n{run.stderr}")
    lib = ctypes.CDLL(str(out))
    c, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_dw_mma.argtypes = [c] * 10 + [i] * 4 + [c]
    lib.probe_wgmma_one.argtypes = [ctypes.c_float, ctypes.c_float, c]
    lib.moe_ffn_bwd_f32.argtypes = [i] + [c] * 19 + [i] * 5 + [c]
    lib.probe_wgmma_rate.argtypes = [i, i, c, c]
    for fn in (lib.probe_dw_mma, lib.probe_wgmma_one, lib.moe_ffn_bwd_f32,
               lib.probe_wgmma_rate):
        fn.restype = i
    return lib, run.stdout + run.stderr


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
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
    return out


def wgmma_tf32(lib) -> dict:
    """What one wgmma.m64n128k8 TF32 reads and how it rounds its sum."""
    import numpy as np
    import torch
    out = torch.zeros(1, device="cuda")

    def one(x, c0):
        err = lib.probe_wgmma_one(x, c0, out.data_ptr())
        if err:
            raise RuntimeError(f"probe_wgmma_one: CUDA error {err}")
        torch.cuda.synchronize()
        return float(out.item())

    def trunc(x):
        return float(np.array([x], np.float32).view(np.int32)
                     .__and__(-0x2000).view(np.float32)[0])
    xs = [1 + 1 / 4096, 1 + 3 / 8192, 1 + 1 / 1024 + 1 / 4096,
          -(1 + 3 / 8192)]
    operand = [{"x": x, "read": one(x, 0.0), "truncated": trunc(x)}
               for x in xs]
    p = 3 / 33554432                       # 0.75 ulp of 1
    got = one(p, 1.0)
    return {"operand": operand,
            "operand_read_truncated": all(o["read"] == o["truncated"]
                                          for o in operand),
            "accumulate": {"c0": 1.0, "x": p, "got": got,
                           "nearest": float(np.float32(1 + p)),
                           "toward_zero": 1.0},
            "sum_rounds_toward_zero": got == 1.0}


def wgmma_rate(lib) -> dict:
    """TF32 TFLOP/s of the consumers' wgmma pattern on every SM (two
    warpgroups, 12 wgmma.m64n128k8 a stage), with the kernel's per-stage
    sums and as one chain."""
    import torch
    from repro_torch.kernels import _build as B
    out = torch.zeros(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    res = {}
    for name, sums in (("stage_sums", 1), ("one_chain", 0)):
        def run():
            B.check(lib.probe_wgmma_rate(sums, iters, out.data_ptr(),
                                         B.current_stream(0)),
                    "probe_wgmma_rate")
        run()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(5):
            run()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / 5
        flops = 2.0 * 64 * 128 * 8 * 12 * 2 * iters * sms
        res[name] = {"ms": ms, "tf32_tflops": flops / ms / 1e9,
                     "tflops_3xtf32": flops / 3 / ms / 1e9}
    return res


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    if not (root / "chip_smoke.py").is_file():
        print(f"moe_bwd_probe: no chip_smoke.py in {root}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import _build as B
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, log = build(root)
    line = {"label": argv[0] if argv else "", "card": cs._card_line(),
            "wgmma_tf32": wgmma_tf32(lib), "wgmma_rate": wgmma_rate(lib)}

    d, ff, E, tokens, top_k = 2048, 1024, 64, 2048, 8
    xg, offs, w, gate, sizes = cs._moe_inputs(d, ff, E, tokens, top_k,
                                              torch.float32, cs.SEED + 40)
    R = xg.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 42)
    dy = torch.randn((R, d), generator=gen, device="cuda")
    dg, du, h = (torch.randn((R, ff), generator=gen, device="cuda") * 0.1
                 for _ in range(3))
    # the kernel's layout: group e from column pad0[e], groups padded to 4
    rp = -(-(R + 3 * E) // 4) * 4
    pad = np.concatenate([[0], np.cumsum((sizes + 3) // 4 * 4)])
    dgt, dut, ht = (torch.zeros((ff, rp), device="cuda") for _ in range(3))
    bounds = offs.tolist()
    for t, src in ((dgt, dg), (dut, du), (ht, h)):
        for e in range(E):
            a, b = bounds[e], bounds[e + 1]
            t[:, pad[e]:pad[e] + b - a] = src[a:b].t()
    stream = B.current_stream(0)
    outs = {k: [torch.empty_like(w[0]), torch.empty_like(w[1]),
                torch.empty_like(w[2])] for k in ("mma", "wgmma")}

    def mma():
        o = outs["mma"]
        B.check(lib.probe_dw_mma(
            xg.data_ptr(), dy.data_ptr(), dg.data_ptr(), du.data_ptr(),
            h.data_ptr(), offs.data_ptr(), gate.data_ptr(), o[0].data_ptr(),
            o[1].data_ptr(), o[2].data_ptr(), R, E, d, ff, stream),
            "probe_dw_mma")

    def wgmma():
        o = outs["wgmma"]
        z = 0
        B.check(lib.moe_ffn_bwd_f32(
            2, dy.data_ptr(), xg.data_ptr(), offs.data_ptr(), z, z, z,
            gate.data_ptr(), z, z, z, dgt.data_ptr(), dut.data_ptr(),
            ht.data_ptr(), z, z, z, o[0].data_ptr(), o[1].data_ptr(),
            o[2].data_ptr(), R, rp, E, d, ff, stream), "moe_ffn_bwd_f32[2]")

    def timed(fn, n=10) -> float:
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    ms = {"mma": [], "wgmma": []}
    for name in ("mma", "wgmma", "wgmma", "mma"):
        ms[name].append(timed(mma if name == "mma" else wgmma))

    # float64 truth per expert
    want = [torch.zeros_like(t, dtype=torch.float64) for t in w]
    for e in range(E):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x = xg[a:b].double()
        want[0][e] = x.T @ dg[a:b].double()
        want[1][e] = x.T @ du[a:b].double()
        want[2][e] = h[a:b].double().T @ (gate[a:b, None] * dy[a:b]).double()
    flops = 6.0 * R * d * ff
    empty = np.flatnonzero(sizes == 0)
    routes, ok = {}, True
    for name in ("mma", "wgmma"):
        o = outs[name]
        errs = [float((g.double() - t).abs().max() / t.abs().max())
                for g, t in zip(o, want)]
        zero = all(int(torch.count_nonzero(g[e])) == 0 for e in empty
                   for g in o)
        best = min(ms[name])
        dig = hashlib.sha256()
        for g in o:
            dig.update(g.cpu().numpy().tobytes())
        routes[name] = {"ms": ms[name], "tflops_3xtf32": flops / best / 1e9,
                        "rel_err_by_product": errs,
                        "empty_experts": len(empty),
                        "empty_experts_dw_exactly_zero": zero,
                        "sha256": dig.hexdigest()[:16]}
        ok &= max(errs) <= TOL and zero
    line["routes"] = routes
    line["shape"] = {"rows": R, "experts": E, "d": d, "ff": ff,
                     "touched_experts": int((sizes > 0).sum())}
    line["bound_ms"] = flops / cs.F32_TC_FLOPS_PER_S * 1e3
    line["ptxas"] = _ptxas(log)
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
