#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. environment: a CUDA card of compute capability 9.0; versions, the
     card's name and power limit; the GPU parity mode.
  2. build: nvcc compiles every kernel of the port from the checkout;
     ptxas's registers and spills per kernel; cuobjdump's SASS of the
     flash libraries must show the bf16 kernel issuing tensor-core
     (HMMA), cp.async (LDGSTS) and ldmatrix (LDSM) instructions.
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes and at unaligned ones: the int8 codec bit-equal
     to the plain version and to the numpy oracle, fedavg_agg within
     rtol=1e-6/atol=1e-7, flash_attention within 1e-5 (fp32, the SIMT
     kernel) at qwen3-0.6b's prefill shapes (S 1024 and 8192, the length
     the reference sends to its blocked scan) and an unaligned non-causal
     window + softcap case, and within 2e-2 (bf16, the tensor-core
     kernel, timed as flash_attention_bf16) at the qwen3 shape and a
     causal hd 64 window 256 + softcap 50 case; wkv6 within 1e-5 at
     rwkv6-1.6b's (B 4, T 1024 and 1000, H 32); device times (CUDA-graph
     replay, CUDA events) beside the plain version, the one-call library
     equivalent (torch.mv for fedavg_agg, scaled_dot_product_attention
     for flash_attention; none for the codec and wkv6) and the bound, plus
     the host-inclusive time of one wrapper call. fedavg_agg_mix is held
     to its plain version bit for bit at the fleet's flush shape (E 32
     distinct update trees, N 188,810 VGG-5 parameters) and at E 1 /
     N 1,000,003, E 4 / N 4,097 and a bf16 global; it is timed with its
     inputs rotated over 6 copies (154 MB, more than the 50 MB L2), the
     plain version and torch.addmv the same way.
  4. quickstart: 3 SP2 split steps at batch 100, a raw-codec migration,
     and a resume bit-identical to never moving; one split step on the
     card against the same step on the CPU.
  5. main path: FedFlyScheduler, delta codec, 4 devices / 2 edges, VGG-5
     at batch 100, 3 rounds, pi3_1 moving edge-A -> edge-B mid-round 1;
     launch counters reset just before and read just after.
  6. profile: one more round with a move, under torch.profiler: the
     card's kernel time and its top kernels; then two rounds without the
     parity mode (timing only).
  7. serve: launch/serve.py's path at full width under the parity mode,
     qwen3-0.6b and rwkv6-1.6b, batch 4, prompt 1024, 16 generated
     tokens, random weights drawn on the card from seed 0; counters reset
     just before each prefill and read after it (flash_attention 28,
     wkv6 24), then around the decode (none); the same prefill with every
     kernel's plain version: last-token logits within atol = rtol = 1e-3
     and the same argmax.
  7b. bf16 prefill: qwen3-0.6b at its published widths with bf16 weights
     and compute (batch 4, prompt 1024, random weights from seed 0),
     counters reset just before and read after: flash_attention_bf16 28,
     flash_attention 0; wall time, tokens/s, the kernel's share, a
     profiled prefill; the same prefill through the plain versions: the
     logits and every cache entry within 5e-2 of their max|x|.
  8. session migration: each model's decode session, taken after 8 of
     the 15 decode steps, moves edge-A -> edge-B: the raw codec resumes
     with next-token logits bit-identical to not moving; the packed int8
     codec (delta with no base) records its bytes, ratio to raw,
     pack/unpack time and its kernel launches.
  9. fleet flush: examples/fleet_sim.py's fleet with 8 cohorts (1000
     clients on 8 edges, VGG-5 at SP2, batch 16, 2-9 batches per epoch,
     SGD momentum 0.9, lr 0.01, 4 replicas per cohort: 32 distinct update
     trees), counters reset first. 2 epochs; each trains every cohort on
     the card, then folds all 1000 contributions in one FedAsync window
     (alpha 0.6, hinge staleness a = 4/1000, b = 2000, staleness drawn
     from 0..2500): flush_batch (exact int64 fold, the committed global),
     the window's flush_coeffs through fedavg_mix_tree (the mix kernel),
     1000 sequential submits, and the same fold on the CPU (bit-identical
     to the card's); plus a SyncAggregator commit of the 32 (tree, summed
     weight) pairs against fedavg (the fedavg_agg kernel). Every float
     form is held to its stated bound of the exact one; fedavg_agg_mix
     and fedavg_agg each launch once per epoch.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS reads this at its first call: set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
MAIN_N_PACKED = 513024        # SP2 checkpoint's packed delta buffer
TESTBED_KERNELS = ("quantize_packed", "dequantize_packed", "fedavg_agg")
VGG5_PARAMS = 188810
BLOCK = 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _median_event_ms(run, reps: int, inner: int) -> float:
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in pairs)


def device_ms(fn, reps: int = 50, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    the graph replayed ``reps`` times between CUDA events, the median
    taken. Replay leaves out the host's launch overhead, so this is the
    work on the card alone (inputs warm in the 50 MB L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, inner)


def call_ms(fn, reps: int = 50, inner: int = 20) -> float:
    """Time per call as a caller on the host sees it: ``inner`` eager
    calls back to back between CUDA events (launch overhead included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _median_event_ms(run, reps, inner)


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability 9.0 (Hopper), "
              f"found {cap}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": cap,
          "count": torch.cuda.device_count()})
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import set_parity_mode
    set_parity_mode()
    return smi


# tensor-core product, cp.async copy, ldmatrix, fp32 fused multiply-add
SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "FFMA")


def phase_build():
    from repro_torch.kernels import native
    secs = native.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in native.BUILD_LOG.items()}
    cuobjdump = Path(native.nvcc()).parent / "cuobjdump"
    sass = {}
    for name in ("flash_attention", "flash_attention_mma"):
        text = subprocess.run(
            [str(cuobjdump), "-sass", str(native.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        sass[name] = {op: len(re.findall(rf"\b{op}\b", text))
                      for op in SASS_OPS}
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": ptxas,
          "sass_instructions": sass})
    missing = [op for op in ("HMMA", "LDGSTS", "LDSM")
               if not sass["flash_attention_mma"][op]]
    if missing:
        raise SystemExit(f"build: the bf16 flash kernel's SASS has no "
                         f"{missing} instructions")


def _codec_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-6, 1, n))
         ).astype(np.float32)
    base = (x + rng.standard_normal(n).astype(np.float32) * 1e-3
            ).astype(np.float32)
    return x, base


def check_codec(n: int, residual: bool, timed: bool):
    """Quantize and dequantize at size n on the card: kernel == plain
    torch version == numpy oracle, bit for bit."""
    from repro_torch.kernels.int8_codec import int8_codec as k
    from repro_torch.kernels.int8_codec import ref
    dev = torch.device("cuda")
    x_np, b_np = _codec_inputs(n, seed=n + residual)
    b_np = b_np if residual else None
    x = torch.from_numpy(x_np).to(dev)
    b = None if b_np is None else torch.from_numpy(b_np).to(dev)
    R = -(-n // BLOCK)

    q, s = k.quantize_packed(x, b)
    q_p, s_p = ref.quantize_packed_ref(x, b)
    q_np, s_np = ref.quantize_packed_np(x_np, b_np)
    torch.cuda.synchronize()
    qh, sh = q.cpu().numpy(), s.cpu().numpy()
    quant_ok = (np.array_equal(qh, q_p.cpu().numpy())
                and np.array_equal(sh.view(np.uint32),
                                   s_p.cpu().numpy().view(np.uint32))
                and np.array_equal(qh[:n], q_np[:n])
                and np.array_equal(sh.view(np.uint32), s_np.view(np.uint32))
                and not qh[n:].any())
    q_err = int(np.abs(qh.astype(np.int32)
                       - q_p.cpu().numpy().astype(np.int32)).max())

    # decode from the container's trimmed form (n bytes, R scales)
    qt = q[:n].contiguous()
    out = k.dequantize_packed(qt, s, n, b)
    out_p = ref.dequantize_packed_ref(qt, s, n, b)
    out_np = ref.dequantize_packed_np(q_np[:n], s_np, n, b_np)
    oh = out.cpu().numpy()
    dequant_ok = (np.array_equal(oh.view(np.uint32),
                                 out_p.cpu().numpy().view(np.uint32))
                  and np.array_equal(oh.view(np.uint32),
                                     out_np.view(np.uint32)))
    d_err = float(np.abs(oh - out_p.cpu().numpy()).max())
    # fewer scales than rows: the missing rows decode with scale 1.0
    few = k.dequantize_packed(qt, s[:max(R - 1, 0)], n, b)
    few_p = ref.dequantize_packed_ref(qt, s[:max(R - 1, 0)], n, b)
    few_ok = torch.equal(few, few_p)

    mode = "residual" if residual else "plain"
    checks = [{"name": "quantize_packed", "mode": mode, "n": n,
               "passed": bool(quant_ok), "max_abs_err": q_err},
              {"name": "dequantize_packed", "mode": mode, "n": n,
               "passed": bool(dequant_ok and few_ok), "max_abs_err": d_err}]
    if not timed:
        return checks

    # timings: raw launches on preallocated buffers (device time per
    # launch), the plain version, and the bound
    qbuf, sbuf = torch.empty_like(q), torch.empty_like(s)
    obuf = torch.empty(n, dtype=torch.float32, device=dev)
    kq = device_ms(lambda: k.launch_quantize(x, b, qbuf, sbuf))
    pq = device_ms(lambda: ref.quantize_packed_ref(x, b))
    wq = call_ms(lambda: k.quantize_packed(x, b))
    kd = device_ms(lambda: k.launch_dequantize(qt, s, b, obuf))
    pd = device_ms(lambda: ref.dequantize_packed_ref(qt, s, n, b))
    wd = call_ms(lambda: k.dequantize_packed(qt, s, n, b))
    extra = 4 * n if residual else 0
    q_bytes = 4 * n + extra + R * BLOCK + 4 * R
    d_bytes = n + 4 * R + extra + 4 * n
    bq = bound(q_bytes, (7 + residual) * n)
    bd = bound(d_bytes, (1 + residual) * n)
    checks[0].update(ms=kq, plain_ms=pq, bound_ms=bq[0], bound_by=bq[1],
                     library_ms=None, wrapper_call_ms=wq, bytes=q_bytes)
    checks[1].update(ms=kd, plain_ms=pd, bound_ms=bd[0], bound_by=bd[1],
                     library_ms=None, wrapper_call_ms=wd, bytes=d_bytes)
    return checks


def check_fedavg(E: int, N: int, timed: bool):
    from repro_torch.kernels.fedavg_agg import fedavg_agg as k
    from repro_torch.kernels.fedavg_agg.ref import (fedavg_agg_ref,
                                                    normalize_weights)
    dev = torch.device("cuda")
    rng = np.random.default_rng(E * 7919 + N)
    stacked = torch.from_numpy(
        rng.standard_normal((E, N)).astype(np.float32)).to(dev)
    weights = rng.uniform(500, 1500, E)
    got = k.fedavg_agg(stacked, weights)
    want = fedavg_agg_ref(stacked, weights)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-6, atol=1e-7))
    entry = {"name": "fedavg_agg", "mode": f"E={E}", "n": N, "passed": ok,
             "max_abs_err": err}
    if timed:
        w = normalize_weights(weights).to(dev)
        out = torch.empty(N, dtype=torch.float32, device=dev)
        st = stacked.t()
        nbytes = 4 * E * N + 4 * E + 4 * N
        b = bound(nbytes, 2 * E * N)
        entry.update(bytes=nbytes,
            ms=device_ms(lambda: k.launch_fedavg_agg(stacked, w, out)),
            plain_ms=device_ms(lambda: fedavg_agg_ref(stacked, weights)),
            bound_ms=b[0], bound_by=b[1],
            library_ms=device_ms(lambda: torch.mv(st, w)),
            wrapper_call_ms=call_ms(lambda: k.fedavg_agg(stacked, weights)))
    return entry


MIX_COPIES = 6                # input copies the mix timing rotates over


def _rotating(fns):
    """One callable that runs ``fns`` in turn, a different one per call:
    timed over input copies that together exceed the L2, each launch
    finds its inputs in device memory, as a flush window's updates are."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def check_fedavg_mix(E: int, N: int, timed: bool, gdtype: str = "float32"):
    """The FedAsync mix kernel against its plain version (bit for bit)."""
    from repro_torch.kernels.fedavg_agg import fedavg_agg as k
    from repro_torch.kernels.fedavg_agg.ref import (fedavg_agg_mix_ref,
                                                    mix_coeffs)
    dev = torch.device("cuda")
    rng = np.random.default_rng(E * 7919 + N + 1)
    sets = []
    for _ in range(MIX_COPIES if timed else 1):
        stacked = torch.from_numpy(
            rng.standard_normal((E, N)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
            dev).to(getattr(torch, gdtype))
        sets.append((g, stacked))
    coeffs = rng.uniform(0.0, 1.0 / E, E)     # effective, sum below 1
    g, stacked = sets[0]
    got = k.fedavg_agg_mix(g, stacked, coeffs)
    want = fedavg_agg_mix_ref(g, stacked, coeffs)
    err = float((got.float() - want.float()).abs().max())
    entry = {"name": "fedavg_agg_mix", "mode": f"E={E} {gdtype} global",
             "n": N, "passed": bool(torch.equal(got, want)),
             "tolerance": "bit-exact", "max_abs_err": err}
    if not timed:
        return entry
    w_np, keep = mix_coeffs(coeffs)
    w = torch.from_numpy(w_np).to(dev)
    outs = [torch.empty(N, dtype=torch.float32, device=dev) for _ in sets]
    nbytes = 4 * E * N + 4 * N + 4 * N + 4 * E
    b = bound(nbytes, 2 * (E + 1) * N)
    entry.update(
        bytes=nbytes, flops=2 * (E + 1) * N, bound_ms=b[0], bound_by=b[1],
        timing=(f"inputs rotated over {MIX_COPIES} copies "
                f"({MIX_COPIES * nbytes} B, more than the 50 MB L2)"),
        ms=device_ms(_rotating([
            lambda g=g, s=s, o=o: k.launch_fedavg_agg_mix(g, s, w, keep, o)
            for (g, s), o in zip(sets, outs)])),
        ms_l2_warm=device_ms(
            lambda: k.launch_fedavg_agg_mix(g, stacked, w, keep, outs[0])),
        plain_ms=device_ms(_rotating([
            lambda g=g, s=s: fedavg_agg_mix_ref(g, s, coeffs)
            for g, s in sets]), reps=10, inner=6),
        library_ms=device_ms(_rotating([
            lambda g=g, s=s: torch.addmv(g, s.t(), w, beta=float(keep))
            for g, s in sets])),
        wrapper_call_ms=call_ms(lambda: k.fedavg_agg_mix(g, stacked, coeffs)))
    return entry


# B, H, KV, S, T, hd, causal, window, softcap, dtype; the first is the
# main path's (one qwen3-0.6b prefill layer at batch 4, prompt 1024), the
# first bf16 one the bf16 prefill's (phase 7b)
FLASH_SHAPES = [
    (4, 16, 8, 1024, 1024, 128, True, 0, 0.0, "float32"),
    (1, 16, 8, 8192, 8192, 128, True, 0, 0.0, "float32"),
    (2, 8, 4, 1000, 777, 64, False, 256, 50.0, "float32"),
    (4, 16, 8, 1024, 1024, 128, True, 0, 0.0, "bfloat16"),
    (2, 8, 4, 1000, 1000, 64, True, 256, 50.0, "bfloat16"),
]
# B, T, H: one rwkv6-1.6b prefill layer at batch 4, prompt 1024; unaligned
WKV6_SHAPES = [(4, 1024, 32), (4, 1000, 32)]


def _flash_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the function needs per (batch, head): the keys
    each row attends (a row with none averages all T keys)."""
    s = np.arange(S, dtype=np.int64)
    hi = np.minimum(s if causal else np.full(S, T - 1), T - 1)
    lo = np.maximum(s - window + 1, 0) if window > 0 else np.zeros(S, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, T).sum())


def _sdpa_ms(q, k, v):
    """scaled_dot_product_attention (causal, GQA) on the same inputs, the
    library yardstick; timed with deterministic mode off (it is not on
    the port's path)."""
    import torch.nn.functional as F
    torch.use_deterministic_algorithms(False)
    try:
        try:
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        except TypeError:       # torch < 2.5: no enable_gqa
            rep = q.shape[1] // k.shape[1]
            ke, ve = (t.repeat_interleave(rep, dim=1) for t in (k, v))
            fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, ke, ve, is_causal=True)
        return device_ms(fn, reps=10, inner=3)
    finally:
        torch.use_deterministic_algorithms(True)


def check_flash(B, H, KV, S, T, hd, causal, window, softcap, dtype):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(S * 7 + T)
    q = torch.randn((B, H, S, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, KV, T, hd), generator=g, device=dev).to(dt)
    v = torch.randn((B, KV, T, hd), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention_fwd(q, k, v, **kw)
    want = fa.flash_attention_fwd(q, k, v, use_kernel=False, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    del want
    esize = q.element_size()
    nbytes = esize * (2 * B * H * S * hd + 2 * B * KV * T * hd)
    flops = 4 * hd * B * H * _flash_pairs(S, T, causal, window)
    b = bound(nbytes, flops, BF16_FLOPS_PER_S if dt == torch.bfloat16
              else FP32_FLOPS_PER_S)
    big = S >= 4096
    out = torch.empty_like(q)
    name = ("flash_attention_bf16" if dt == torch.bfloat16
            else "flash_attention")
    entry = {"name": name, "mode": (
        f"B{B} H{H} KV{KV} S{S} T{T} hd{hd} {dtype} "
        f"{'causal' if causal else 'non-causal'} window {window} "
        f"softcap {softcap:g}"), "n": B * H * S * hd, "passed": ok,
        "tolerance": tol, "max_abs_err": err, "bytes": nbytes,
        "flops": flops, "bound_ms": b[0], "bound_by": b[1],
        "ms": device_ms(lambda: fa.launch_flash_attention(
            q, k, v, out, **kw), reps=10 if big else 50,
            inner=3 if big else 20),
        "plain_ms": device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, use_kernel=False, **kw), reps=3 if big else 10,
            inner=1 if big else 3),
        "wrapper_call_ms": call_ms(lambda: fa.flash_attention_fwd(
            q, k, v, **kw), reps=10 if big else 50, inner=3 if big else 20),
        "library_ms": (_sdpa_ms(q, k, v) if causal and not window
                       and not softcap and S == T else None)}
    return entry


def check_wkv6(B, T, H):
    from repro_torch.kernels.wkv6 import wkv6 as wk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(T * 13 + H)
    shape = (B, T, H, 64)
    r, k, v = (torch.randn(shape, generator=g, device=dev) * 0.5
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, generator=g, device=dev)) * 0.5 + 0.4
    u = torch.randn((H, 64), generator=g, device=dev) * 0.1
    y, s = wk.wkv6(r, k, v, w, u)
    y_p, s_p = wk.wkv6(r, k, v, w, u, use_kernel=False)
    err = max(float((y - y_p).abs().max()), float((s - s_p).abs().max()))
    ok = bool(torch.allclose(y, y_p, atol=1e-5, rtol=1e-5)
              and torch.allclose(s, s_p, atol=1e-5, rtol=1e-5))
    nbytes = 4 * (5 * B * T * H * 64 + H * 64 + B * H * 64 * 64)
    # per token and head, what the function needs: y_j = sum_i r_i S_ij
    # (2 per entry) + v_j * sum_i r_i u_i k_i (5 per column), and
    # S = S * w + k v^T (3 per entry)
    flops = (5 * 64 * 64 + 5 * 64) * B * T * H
    b = bound(nbytes, flops)
    yb, sb = torch.empty_like(y), torch.empty_like(s)
    return {"name": "wkv6", "mode": f"B{B} T{T} H{H} K64 float32",
            "n": B * T * H * 64, "passed": ok, "tolerance": 1e-5,
            "max_abs_err": err, "bytes": nbytes, "flops": flops,
            "bound_ms": b[0], "bound_by": b[1],
            "ms": device_ms(lambda: wk.launch_wkv6(r, k, v, w, u, None, yb,
                                                   sb), reps=20, inner=5),
            "plain_ms": device_ms(lambda: wk.wkv6(r, k, v, w, u,
                                                  use_kernel=False),
                                  reps=3, inner=1),
            "wrapper_call_ms": call_ms(lambda: wk.wkv6(r, k, v, w, u),
                                       reps=20, inner=5),
            "library_ms": None}


def phase_kernels():
    timed, checks = [], []
    for residual in (False, True):
        timed += check_codec(MAIN_N_PACKED, residual, timed=True)
        checks += check_codec(1000003, residual, timed=False)
    timed.append(check_fedavg(4, VGG5_PARAMS, timed=True))
    checks.append(check_fedavg(4, 1000003, timed=False))
    timed.append(check_fedavg_mix(32, VGG5_PARAMS, timed=True))
    checks.append(check_fedavg_mix(1, 1000003, timed=False))
    checks.append(check_fedavg_mix(4, 4097, timed=False))
    checks.append(check_fedavg_mix(4, 4097, timed=False, gdtype="bfloat16"))
    for i, shape in enumerate(FLASH_SHAPES):
        keep = i == 0 or shape[-1] == "bfloat16"
        (timed if keep else checks).append(check_flash(*shape))
    for i, shape in enumerate(WKV6_SHAPES):
        (timed if i == 0 else checks).append(check_wkv6(*shape))
    for c in timed + checks:
        emit({"check": c})
    failed = [c for c in timed + checks if not c["passed"]]
    if failed:
        raise SystemExit(f"kernel checks failed: {failed}")
    return timed


def phase_quickstart():
    from repro_torch.core import split
    from repro_torch.core.checkpoint import EdgeCheckpoint
    from repro_torch.core.migration import MigrationExecutor
    from repro_torch.models.vgg import VGG5
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    model = VGG5(device=dev)
    opt = sgd(momentum=0.9)
    params = model.init(torch.Generator().manual_seed(0))
    d, s = split.partition_params(model, params, 2)
    d_opt, s_opt = opt.init(d), opt.init(s)
    g = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn(100, 32, 32, 3, generator=g).to(dev),
             "labels": torch.randint(0, 10, (100,), generator=g).to(dev)}

    def step(d, s, d_opt, s_opt):
        loss, g_d, g_s = split.split_value_and_grad(model, d, s, batch, 2)
        d, d_opt = opt.update(g_d, d_opt, d, 0.01)
        s, s_opt = opt.update(g_s, s_opt, s, 0.01)
        return d, s, d_opt, s_opt, loss

    losses = []
    for _ in range(3):
        d, s, d_opt, s_opt, loss = step(d, s, d_opt, s_opt)
        losses.append(float(loss))
    ck = EdgeCheckpoint(client_id="device-0", round_idx=0, epoch=0,
                        batch_idx=3, split_point=2, server_params=s,
                        optimizer_state=s_opt, loss=losses[-1])
    restored, rep = MigrationExecutor(device=dev).migrate(ck, "edge-A",
                                                          "edge-B")
    a = step(d, s, d_opt, s_opt)
    b = step(d, restored.server_params, d_opt, restored.optimizer_state)
    same = all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a[:4]), tree_leaves(b[:4])))
    if not same or not all(np.isfinite(losses)):
        raise SystemExit(f"quickstart resume not bit-identical "
                         f"(same={same}, losses={losses})")

    # the card's split step against the CPU's on a small batch
    small = {k: v[:8] for k, v in batch.items()}
    cpu = torch.device("cpu")
    l_g, gd_g, gs_g = split.split_value_and_grad(model, d, s, small, 2)
    l_c, gd_c, gs_c = split.split_value_and_grad(
        model, tree_map(lambda t: t.to(cpu), d),
        tree_map(lambda t: t.to(cpu), s),
        {k: v.to(cpu) for k, v in small.items()}, 2)
    grad_err = max(float((x.cpu() - y).abs().max()) for x, y in
                   zip(tree_leaves([gd_g, gs_g]), tree_leaves([gd_c, gs_c])))
    loss_rel = abs(float(l_g) - float(l_c)) / abs(float(l_c))
    if loss_rel > 1e-5 or grad_err > 1e-4:
        raise SystemExit(f"card vs CPU split step: loss rel {loss_rel}, "
                         f"grad err {grad_err}")
    emit({"phase": "quickstart", "losses": losses,
          "resume_bit_identical": same, "raw_nbytes": rep.nbytes,
          "pack_s": rep.pack_s, "unpack_s": rep.unpack_s,
          "card_vs_cpu_loss_rel": loss_rel,
          "card_vs_cpu_grad_max_abs": grad_err})


def phase_main_path():
    from repro_torch.core.checkpoint import EdgeCheckpoint
    from repro_torch.core.mobility import MobilityTrace, move_at_round
    from repro_torch.core.scheduler import FedFlyScheduler
    from repro_torch.data.datasets import synthetic_cifar10
    from repro_torch.data.loader import Batcher
    from repro_torch.data.partition import by_fraction
    from repro_torch.kernels import native
    from repro_torch.models.vgg import VGG5
    from repro_torch.optim.optimizers import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.runtime.cluster import (WIFI_75MBPS,
                                             make_testbed_devices,
                                             make_testbed_edges)

    dev = torch.device("cuda")
    train, _ = synthetic_cifar10(n_train=4000, n_test=200)
    batchers = [Batcher(p, 100) for p in by_fraction(train, [0.25] * 4)]
    sched = FedFlyScheduler(
        VGG5(device=dev), sgd(momentum=0.9), make_testbed_devices(batchers),
        make_testbed_edges(), split_point=2, lr_schedule=constant(0.01),
        link=WIFI_75MBPS, migration_codec="delta", seed=0, device=dev)
    trace = MobilityTrace(move_at_round("pi3_1", "edge-A", "edge-B", 1, 0.5))

    sched.initialize()
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    hist = sched.run(3, trace, mode="fedfly")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)

    reports = sched.migrator.reports
    state = sched.edges["edge-B"].clients["pi3_1"]
    raw_nbytes = EdgeCheckpoint(
        client_id="pi3_1", round_idx=1, epoch=1, batch_idx=5,
        split_point=2, server_params=state.srv_params,
        optimizer_state=state.srv_opt, last_grads=state.last_grads
    ).nbytes("raw", device=dev)
    losses = [v for r in hist.rounds for v in r.client_losses.values()]
    problems = []
    if len(reports) != 1:
        problems.append(f"{len(reports)} migrations, expected 1")
    rep = reports[0] if reports else None
    if rep is not None and rep.nbytes > 0.35 * raw_nbytes:
        problems.append(f"delta payload {rep.nbytes} B > 0.35 x raw "
                        f"{raw_nbytes} B")
    if rep is not None and not (np.isfinite(rep.quant_error)
                                and rep.quant_error < 1e-2):
        problems.append(f"quant_error {rep.quant_error}")
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite losses {losses}")
    if (min(launches[k] for k in TESTBED_KERNELS) < 1
            or launches["fedavg_agg"] != 3):
        problems.append(f"kernel launches on the main path: {launches}")
    emit({"phase": "main_path", "rounds": [
        {"round": r.round_idx, "sim_s": r.round_time_sim,
         "slowest_client_wall_s": r.round_time_wall,
         "loss": float(np.mean(list(r.client_losses.values())))}
        for r in hist.rounds], "wall_s_total": wall,
        "round_wall_s_mean": wall / len(hist.rounds),
        "migration": None if rep is None else {
            "nbytes": rep.nbytes, "raw_nbytes": raw_nbytes,
            "ratio": rep.nbytes / raw_nbytes, "pack_s": rep.pack_s,
            "unpack_s": rep.unpack_s, "sim_transfer_s": rep.sim_transfer_s,
            "quant_error": rep.quant_error,
            "base_version": rep.base_version},
        "launches": launches})
    if problems:
        raise SystemExit("main path failed: " + "; ".join(problems))
    return launches, sched, wall / len(hist.rounds)


def profile_device(fn):
    """Run ``fn`` once under torch.profiler. Returns (profiled wall ms,
    the card's summed kernel ms, [(kernel, ms, count)] by device time).
    The profiler slows the host, so compare the kernel time with an
    unprofiled wall time of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows


def _top(rows, n):
    return [{"name": k[:90], "ms": t, "count": c} for k, t, c in rows[:n]]


def phase_profile(sched, round_wall_s: float):
    """One more round (pi3_1 moving back mid-round) under torch.profiler:
    the card's kernel time against the unprofiled round wall time (the
    profiler slows the host), and the kernels that take the most device
    time. Then two rounds without the parity mode, to see what it costs."""
    from repro_torch.core.mobility import MobilityTrace, move_at_round
    from repro_torch.device import set_parity_mode
    trace = MobilityTrace(move_at_round("pi3_1", "edge-B", "edge-A", 3, 0.5))
    prof_wall_ms, kernel_ms, rows = profile_device(
        lambda: sched.run_round(3, trace, mode="fedfly"))
    wall_ms = 1e3 * round_wall_s        # mean whole-round wall, phase 5

    walls = []
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.benchmark = True
    for r in (4, 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run_round(r, None, mode="fedfly")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    set_parity_mode()
    torch.backends.cudnn.benchmark = False
    emit({"phase": "profile", "device_kernel_ms": kernel_ms,
          "device_kernels": sum(r[2] for r in rows),
          "profiled_round_wall_ms": prof_wall_ms,
          "unprofiled_round_wall_ms": wall_ms,
          "device_busy_share": kernel_ms / wall_ms,
          "top_device": _top(rows, 12),
          "round_wall_s_without_parity_mode": walls})


SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 16
SERVE_SPLIT = 8                 # decode steps before the session moves
SERVE_TOL = 1e-3                # kernel vs plain last-token logits


def phase_serve(arch: str, kernel_ms: dict):
    """launch/serve.py's path at full width: prefill, then greedy decode
    in two runs with the session snapshot between them (phase 8)."""
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.kernels import native
    from repro_torch.launch import serve, steps
    from repro_torch.models.registry import build_model, get_config

    dev = torch.device("cuda")
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    batch = {"tokens": torch.from_numpy(synthetic_tokens(
        B, S, cfg.vocab_size, 0)["tokens"]).to(dev)}
    # warm-up (cuBLAS handles, first-call costs) on a short prompt
    steps.make_prefill_step(model)({"tokens": batch["tokens"][:, :64]})

    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    logits, cache = serve.build_cache_from_prefill(model, cfg, batch, S,
                                                   S + G)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(native.LAUNCHES)
    prefill_logits = logits

    native.reset_launches()
    t0 = time.perf_counter()
    toks_a, logits = serve.generate(model, cache, logits, S, SERVE_SPLIT)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    snapshot = {k: v.clone() for k, v in cache.items()}
    next_tok = serve.greedy(logits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_b, logits = serve.generate(model, cache, logits, S + SERVE_SPLIT,
                                    G - 1 - SERVE_SPLIT)
    torch.cuda.synchronize()
    decode_s += time.perf_counter() - t0
    decode_launches = dict(native.LAUNCHES)
    tokens = torch.cat([toks_a, toks_b[:, 1:]], dim=1)

    # one more decode step, and the prefill again, under torch.profiler:
    # the card's kernel time against the unprofiled wall time
    _, dec_kernel_ms, dec_rows = profile_device(
        lambda: steps.make_serve_step(model)(cache, serve.greedy(logits),
                                             S + G - 1))
    kernel_prefill = []
    _, pre_kernel_ms, pre_rows = profile_device(
        lambda: kernel_prefill.append(steps.make_prefill_step(model)(batch)))
    kernel_aux = kernel_prefill.pop()[1]

    # the same prefill through every kernel's plain version: the logits,
    # and every cache entry the prefill collects (the kernels' state and
    # k/v reach the logits only through the cache)
    model.use_kernel = False
    plain_logits, plain_aux = steps.make_prefill_step(model)(batch)
    model.use_kernel = None
    err = float((prefill_logits - plain_logits).abs().max())
    close = bool(torch.allclose(prefill_logits, plain_logits, atol=SERVE_TOL,
                                rtol=SERVE_TOL))
    same_argmax = bool(torch.equal(serve.greedy(prefill_logits),
                                   serve.greedy(plain_logits)))
    cache_err = {k: float((kernel_aux[k] - plain_aux[k]).abs().max())
                 for k in plain_aux}
    cache_close = {k: bool(torch.allclose(kernel_aux[k], plain_aux[k],
                                          atol=SERVE_TOL, rtol=SERVE_TOL))
                   for k in plain_aux}
    del kernel_aux, plain_aux

    name = "flash_attention" if not cfg.rwkv else "wkv6"
    want = {"flash_attention": 0 if cfg.rwkv else cfg.num_layers,
            "flash_attention_bf16": 0,
            "wkv6": cfg.num_layers if cfg.rwkv else 0}
    problems = []
    for k, n in want.items():
        if prefill_launches[k] != n:
            problems.append(f"prefill launched {k} {prefill_launches[k]} "
                            f"times, expected {n}")
        if decode_launches[k] != 0:
            problems.append(f"decode launched {k} {decode_launches[k]} times")
    if not close or not same_argmax:
        problems.append(f"kernel vs plain prefill logits: max abs err {err}, "
                        f"same argmax {same_argmax}")
    if not all(cache_close.values()):
        problems.append(f"kernel vs plain prefill cache: max abs err "
                        f"{cache_err}")
    if not bool(torch.isfinite(logits).all()) or tokens.shape != (B, G):
        problems.append(f"decode: tokens {tuple(tokens.shape)}, finite "
                        f"{bool(torch.isfinite(logits).all())}")
    steps_n = G - 1
    emit({"phase": "serve", "arch": arch, "params": sum(
        p.numel() for p in model.parameters()), "init_s": init_s,
        "batch": B, "prompt": S, "gen": G, "prefill_s": prefill_s,
        "prefill_tok_per_s": B * S / prefill_s, "decode_s": decode_s,
        "decode_step_ms": 1e3 * decode_s / steps_n,
        "decode_tok_per_s": B * steps_n / decode_s,
        "prefill_launches": prefill_launches,
        "decode_launches": decode_launches,
        "kernel_share_of_prefill": (
            prefill_launches[name] * kernel_ms[name] / 1e3 / prefill_s),
        "prefill_device_kernel_ms": pre_kernel_ms,
        "prefill_device_kernels": sum(r[2] for r in pre_rows),
        "prefill_device_busy_share": pre_kernel_ms / 1e3 / prefill_s,
        "prefill_top_device": _top(pre_rows, 6),
        "decode_step_device_kernel_ms": dec_kernel_ms,
        "decode_step_device_kernels": sum(r[2] for r in dec_rows),
        "decode_device_busy_share": dec_kernel_ms / (1e3 * decode_s
                                                     / steps_n),
        "decode_top_device": _top(dec_rows, 6),
        "kernel_vs_plain_logits_max_abs_err": err,
        "tolerance": SERVE_TOL, "same_argmax": same_argmax,
        "kernel_vs_plain_cache_max_abs_err": cache_err,
        "tokens_seq0": tokens[0].tolist()})
    if problems:
        raise SystemExit(f"serve {arch} failed: " + "; ".join(problems))
    return model, snapshot, next_tok, prefill_launches


def phase_session(arch: str, model, snapshot, next_tok):
    """Move the decode session taken after SERVE_SPLIT decode steps."""
    from repro_torch.core.migration import MigrationExecutor
    from repro_torch.core.serve_migration import ServeSession, migrate_session
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    pos = SERVE_PROMPT + SERVE_SPLIT
    sess = ServeSession(f"{arch}-session", snapshot, position=pos,
                        tokens_generated=SERVE_SPLIT + 1)
    raw_nbytes = sum(t.numel() * t.element_size() for t in snapshot.values())
    restored, rep = migrate_session(sess, MigrationExecutor(device=dev),
                                    "edge-A", "edge-B")
    native.reset_launches()
    q_sess, q_rep = migrate_session(
        sess, MigrationExecutor(codec="delta", device=dev), "edge-A",
        "edge-B")
    torch.cuda.synchronize()
    q_launches = {k: native.LAUNCHES[k] for k in ("quantize_packed",
                                                  "dequantize_packed")}
    l_moved, _ = model.decode_step(restored.cache, next_tok, pos)
    l_q, _ = model.decode_step(q_sess.cache, next_tok, pos)
    l_direct, _ = model.decode_step(snapshot, next_tok, pos)
    same = bool(torch.equal(l_moved, l_direct))
    emit({"phase": "session", "arch": arch, "position": pos,
          "cache_bytes": raw_nbytes,
          "raw": {"nbytes": rep.nbytes, "pack_ms": 1e3 * rep.pack_s,
                  "unpack_ms": 1e3 * rep.unpack_s,
                  "sim_transfer_s": rep.sim_transfer_s,
                  "resume_bit_identical": same},
          "int8_packed": {"codec": "delta, no base: blockwise int8 on the "
                                   "card", "nbytes": q_rep.nbytes,
                          "ratio_to_raw": q_rep.nbytes / rep.nbytes,
                          "pack_ms": 1e3 * q_rep.pack_s,
                          "unpack_ms": 1e3 * q_rep.unpack_s,
                          "sim_transfer_s": q_rep.sim_transfer_s,
                          "quant_error": q_rep.quant_error,
                          "launches": q_launches,
                          "next_logits_max_abs_diff": float(
                              (l_q - l_direct).abs().max()),
                          "same_next_token": bool(torch.equal(
                              l_q.argmax(-1), l_direct.argmax(-1)))}})
    if (not same or restored.position != pos
            or min(q_launches.values()) != 1
            or q_rep.nbytes > 0.3 * rep.nbytes):
        raise SystemExit(f"session migration {arch} failed: resume "
                         f"bit-identical {same}, int8 launches {q_launches}, "
                         f"int8 {q_rep.nbytes} B of raw {rep.nbytes} B")


def clocked(seconds: dict, name: str, fn, *args):
    """Call ``fn(*args)``, adding its wall time to ``seconds[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    return out


def phase_serve_and_migrate(kernel_ms: dict, seconds: dict):
    serve_launches = {}
    for arch in ("qwen3-0.6b", "rwkv6-1.6b"):
        model, snapshot, next_tok, launches = clocked(
            seconds, "7_serve", phase_serve, arch, kernel_ms)
        clocked(seconds, "8_session", phase_session, arch, model, snapshot,
              next_tok)
        for k, n in launches.items():
            serve_launches[k] = serve_launches.get(k, 0) + n
        del model, snapshot
        torch.cuda.empty_cache()
    return serve_launches


PREFILL_BF16_TOL = 5e-2         # kernel vs plain, of each tensor's max|x|


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def phase_prefill_bf16(kernel_ms: dict):
    """One qwen3-0.6b prefill at its published widths with bf16 weights
    and compute: every layer's attention on the bf16 tensor-core kernel.
    Against the same prefill through the plain versions, each tensor is
    held to PREFILL_BF16_TOL of its max|x|: bf16 rounds every op's output
    (2^-8 relative), the kernel rounds P and its output where the plain
    version rounds only its output, and 28 layers carry the difference; a
    wrong kernel moves the logits by their own scale."""
    from repro_torch.data.datasets import synthetic_tokens
    from repro_torch.kernels import native
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model, get_config

    dev = torch.device("cuda")
    cfg = get_config("qwen3-0.6b").replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    B, S = SERVE_BATCH, SERVE_PROMPT
    batch = {"tokens": torch.from_numpy(synthetic_tokens(
        B, S, cfg.vocab_size, 0)["tokens"]).to(dev)}
    prefill = steps.make_prefill_step(model)
    prefill({"tokens": batch["tokens"][:, :64]})      # warm-up

    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    logits, aux = prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    _, dev_ms, rows = profile_device(lambda: prefill(batch))

    model.use_kernel = False
    plain_logits, plain_aux = prefill(batch)
    model.use_kernel = None
    errs = {"logits": _rel_err(logits, plain_logits),
            **{k: _rel_err(aux[k], plain_aux[k]) for k in plain_aux}}
    del aux, plain_aux

    name = "flash_attention_bf16"
    problems = []
    if launches[name] != cfg.num_layers or launches["flash_attention"]:
        problems.append(f"launches {launches}, expected {name} "
                        f"{cfg.num_layers} and flash_attention 0")
    if (logits.shape != (B, 1, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        problems.append(f"logits {tuple(logits.shape)}, finite "
                        f"{bool(torch.isfinite(logits).all())}")
    if max(errs.values()) > PREFILL_BF16_TOL:
        problems.append(f"kernel vs plain relative error {errs}")
    emit({"phase": "prefill_bf16", "arch": cfg.name, "dtype": "bfloat16",
          "params": sum(p.numel() for p in model.parameters()),
          "batch": B, "prompt": S, "prefill_s": prefill_s,
          "prefill_tok_per_s": B * S / prefill_s, "launches": launches,
          "kernel_ms": kernel_ms[name],
          "kernel_share_of_prefill": (
              launches[name] * kernel_ms[name] / 1e3 / prefill_s),
          "prefill_device_kernel_ms": dev_ms,
          "prefill_device_kernels": sum(r[2] for r in rows),
          "prefill_device_busy_share": dev_ms / 1e3 / prefill_s,
          "prefill_top_device": _top(rows, 6),
          "kernel_vs_plain_rel_err": errs, "tolerance": PREFILL_BF16_TOL})
    if problems:
        raise SystemExit("bf16 prefill failed: " + "; ".join(problems))
    return launches


FLEET_CLIENTS, FLEET_EDGES, FLEET_COHORTS, FLEET_EPOCHS = 1000, 8, 8, 2
FLEET_MAX_STALENESS = 2500


def _float_leaves(tree):
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(tree) if t.is_floating_point()]


def _max_abs(trees) -> float:
    return max(float(t.abs().max()) for tree in trees
               for t in _float_leaves(tree))


def _max_diff(a, b) -> float:
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(_float_leaves(a), _float_leaves(b)))


def _fleet_window(fleet, epoch: int, rng):
    """Every client's contribution of ``epoch``, in client order, with a
    drawn staleness: (tree, weight, staleness). Clients of one replica
    share its tree object."""
    return [(fleet.contribution(c, epoch)[0], c.spec.num_samples,
             int(rng.integers(0, FLEET_MAX_STALENESS + 1)))
            for c in fleet.clients.values()]


def _flush_epoch(fleet, agg, window):
    """One FedAsync window through the exact fold (committed on ``agg``),
    the mix kernel, sequential submits and the CPU fold; and the sync
    FedAvg of its distinct trees through the int64 fold and the
    fedavg_agg kernel. Returns the epoch's record."""
    from repro_torch.core.fedavg import fedavg
    from repro_torch.kernels.fedavg_agg.ops import (coeff_fold_tree,
                                                    fedavg_mix_tree)
    from repro_torch.sim import SyncAggregator
    from repro_torch.tree import tree_leaves, tree_map

    def on_cpu(tree):
        return tree_map(lambda t: t.cpu(), tree)

    mixer, seq, cpu = (copy.deepcopy(agg) for _ in range(3))
    cpu.params = on_cpu(cpu.params)
    rec = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alphas = agg.flush_batch(window)
    torch.cuda.synchronize()
    rec["fold_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, grouped, keep = mixer.flush_coeffs([(id(t), w, s)
                                           for t, w, s in window])
    trees = {id(t): t for t, _, _ in window}
    mixed = fedavg_mix_tree(mixer.params, [trees[k] for k in grouped],
                            list(grouped.values()))
    torch.cuda.synchronize()
    rec["kernel_mix_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for t, w, st in window:
        seq.submit(t, w, st)
    torch.cuda.synchronize()
    rec["submits_s"] = time.perf_counter() - t0

    cpu_trees = {k: on_cpu(t) for k, t in trees.items()}
    t0 = time.perf_counter()
    cpu.flush_batch([(cpu_trees[id(t)], w, st) for t, w, st in window])
    rec["cpu_fold_s"] = time.perf_counter() - t0
    acc = coeff_fold_tree([trees[k] for k in grouped], list(grouped.values()))
    acc_cpu = coeff_fold_tree([cpu_trees[k] for k in grouped],
                              list(grouped.values()))
    fold_bits = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves([acc, agg.params]), tree_leaves([acc_cpu, cpu.params])))

    E, n = len(grouped), len(window)
    max_g, max_u = _max_abs([mixer.params]), _max_abs(trees.values())
    sum_c = sum(abs(c) for c in grouped.values())
    mix_bound = (E + 2) * 2.0 ** -23 * (abs(keep) * max_g + sum_c * max_u)
    seq_bound = 3 * n * 2.0 ** -23 * max(max_g, max_u)

    summed = {}
    for t, w, _ in window:
        summed[id(t)] = summed.get(id(t), 0.0) + w
    sync = SyncAggregator(mixer.params)
    for k, w in summed.items():
        sync.submit(trees[k], w)
    t0 = time.perf_counter()
    sync_params = sync.commit()
    torch.cuda.synchronize()
    rec["sync_fold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    averaged = fedavg([trees[k] for k in summed], list(summed.values()))
    torch.cuda.synchronize()
    rec["sync_kernel_s"] = time.perf_counter() - t0

    rec.update(
        updates=n, distinct_trees=E, keep=keep,
        hinged=sum(1 for _, _, st in window if st > 2000),
        alpha_sum=sum(alphas),
        kernel_mix_vs_fold=_max_diff(mixed, agg.params),
        kernel_mix_bound=mix_bound,
        submits_vs_fold=_max_diff(seq.params, agg.params),
        submits_bound=seq_bound,
        card_vs_cpu_fold=_max_diff(agg.params, cpu.params),
        card_fold_bit_identical_to_cpu=fold_bits,
        sync_kernel_vs_fold=_max_diff(averaged, sync_params),
        sync_kernel_bound=(E + 2) * 2.0 ** -23 * max_u,
        finite=all(bool(torch.isfinite(t).all())
                   for t in _float_leaves(agg.params)))
    return rec


def phase_fleet_flush():
    """examples/fleet_sim.py's fleet (FLEET_SIM_COHORTS=8) on the card:
    2 epochs, each flushed as one FedAsync window of all 1000 clients."""
    from repro_torch.kernels import native
    from repro_torch.models.vgg import VGG5
    from repro_torch.optim.optimizers import sgd
    from repro_torch.optim.schedules import constant
    from repro_torch.sim import (AsyncAggregator, Fleet, hinge_staleness,
                                 make_fleet_specs)

    dev = torch.device("cuda")
    specs = make_fleet_specs(FLEET_CLIENTS,
                             [f"edge-{i}" for i in range(FLEET_EDGES)],
                             batch_size=16, num_batches=2,
                             cohorts=FLEET_COHORTS)
    fleet = Fleet(VGG5(device=dev), sgd(momentum=0.9), specs,
                  split_point=2, lr_schedule=constant(0.01), max_replicas=4,
                  seed=0, device=dev)
    table = fleet.cohort_tables("delta")
    key0 = min(table)
    agg = AsyncAggregator(fleet.global_params, alpha=0.6,
                          staleness_fn=hinge_staleness(
                              a=4.0 / FLEET_CLIENTS, b=2.0 * FLEET_CLIENTS))
    rng = np.random.default_rng(0)
    first = {}
    for c in fleet.clients.values():
        first.setdefault(c.spec.cohort_key, c)

    torch.cuda.synchronize()
    native.reset_launches()
    epochs = []
    for epoch in range(FLEET_EPOCHS):
        t0 = time.perf_counter()
        for c in first.values():
            fleet.ensure_epoch(c, epoch)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        rec = _flush_epoch(fleet, agg, _fleet_window(fleet, epoch, rng))
        fleet.set_global(agg.params)
        losses = np.concatenate([c.losses[epoch]
                                 for c in fleet.cohorts.values()])
        rec.update(epoch=epoch, train_s=train_s,
                   loss_mean=float(losses.mean()),
                   losses_finite=bool(np.isfinite(losses).all()))
        epochs.append(rec)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)

    problems = []
    for r in epochs:
        for k in ("kernel_mix", "submits", "sync_kernel"):
            diff = r[f"{k}_vs_fold"]
            if not diff <= r[f"{k}_bound"]:
                problems.append(f"epoch {r['epoch']}: {k} differs from the "
                                f"exact fold by {diff} > {r[f'{k}_bound']}")
        if not r["card_fold_bit_identical_to_cpu"]:
            problems.append(f"epoch {r['epoch']}: card fold != CPU fold "
                            f"({r['card_vs_cpu_fold']})")
        if r["distinct_trees"] != FLEET_COHORTS * 4 or r["updates"] != \
                FLEET_CLIENTS:
            problems.append(f"epoch {r['epoch']}: {r['updates']} updates of "
                            f"{r['distinct_trees']} trees")
        if not (r["finite"] and r["losses_finite"]):
            problems.append(f"epoch {r['epoch']}: non-finite values")
    if launches["fedavg_agg_mix"] != FLEET_EPOCHS or \
            launches["fedavg_agg"] != FLEET_EPOCHS:
        problems.append(f"launches {launches}")
    emit({"phase": "fleet_flush", "clients": FLEET_CLIENTS,
          "cohorts": len(fleet.cohorts), "replicas_per_cohort": 4,
          "tree_bytes": table[key0]["update"],
          "first_cohort_table_delta": {"cohort": list(key0), **table[key0]},
          "aggregator_version": agg.version, "epochs": epochs,
          "launches": launches})
    if problems:
        raise SystemExit("fleet flush failed: " + "; ".join(problems))
    return launches


SOURCES = {"quantize_packed": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                               "src/repro/kernels/int8_codec/int8_codec.py:87"),
           "dequantize_packed": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                                 "src/repro/kernels/int8_codec/int8_codec.py:121"),
           "fedavg_agg": ("src/repro_torch/kernels/csrc/fedavg_agg.cu",
                          "src/repro/kernels/fedavg_agg/fedavg_agg.py:68"),
           "fedavg_agg_mix": ("src/repro_torch/kernels/csrc/fedavg_agg.cu",
                              "src/repro/kernels/fedavg_agg/fedavg_agg.py:92"),
           "flash_attention": (
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:75"),
           "flash_attention_bf16": (
               "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:75"),
           "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
                    "src/repro/kernels/wkv6/wkv6.py:55")}


def main() -> int:
    t_start = time.perf_counter()
    secs: dict = {}
    smi = clocked(secs, "1_environment", phase_environment)
    clocked(secs, "2_build", phase_build)
    checked = clocked(secs, "3_kernels", phase_kernels)
    clocked(secs, "4_quickstart", phase_quickstart)
    launches, sched, round_wall_s = clocked(secs, "5_main_path",
                                          phase_main_path)
    clocked(secs, "6_profile", phase_profile, sched, round_wall_s)
    del sched
    kernel_ms: dict = {}            # each kernel's main-shape time
    for c in checked:
        kernel_ms.setdefault(c["name"], c["ms"])
    serve_launches = phase_serve_and_migrate(kernel_ms, secs)
    bf16_launches = clocked(secs, "7b_prefill_bf16", phase_prefill_bf16,
                            kernel_ms)
    fleet_launches = clocked(secs, "9_fleet_flush", phase_fleet_flush)
    emit({"phase": "timing", "seconds": secs,
          "total_s": time.perf_counter() - t_start})
    launches.update({k: serve_launches[k] for k in ("flash_attention",
                                                    "wkv6")})
    launches["fedavg_agg_mix"] = fleet_launches["fedavg_agg_mix"]
    launches["flash_attention_bf16"] = bf16_launches["flash_attention_bf16"]
    kernels = []
    for c in checked:
        src, repl = SOURCES[c["name"]]
        kernels.append({
            "name": c["name"], "route": "cuda", "source": src,
            "replaces": repl, "launches": launches[c["name"]],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "mode": c["mode"], "n": c["n"], "passed": c["passed"],
            "kernel_us": c["ms"] * 1e3, "plain_us": c["plain_ms"] * 1e3,
            "library_us": (None if c["library_ms"] is None
                           else c["library_ms"] * 1e3),
            "bound_us": c["bound_ms"] * 1e3, "bytes": c["bytes"],
            "wrapper_call_ms": c["wrapper_call_ms"],
            **{k: c[k] for k in ("timing", "ms_l2_warm") if k in c}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
