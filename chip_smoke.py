#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. environment: a CUDA card of compute capability 9.0; versions, the
     card's name and power limit; the GPU parity mode.
  2. build: nvcc compiles every kernel of the port from the checkout.
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes and at unaligned ones: the int8 codec bit-equal
     to the plain version and to the numpy oracle, fedavg_agg within
     rtol=1e-6/atol=1e-7; device times (CUDA-graph replay, CUDA events)
     beside the plain version, the one-call library equivalent (torch.mv
     for fedavg_agg) and the bound, plus the host-inclusive time of one
     wrapper call.
  4. quickstart: 3 SP2 split steps at batch 100, a raw-codec migration,
     and a resume bit-identical to never moving; one split step on the
     card against the same step on the CPU.
  5. main path: FedFlyScheduler, delta codec, 4 devices / 2 edges, VGG-5
     at batch 100, 3 rounds, pi3_1 moving edge-A -> edge-B mid-round 1;
     launch counters reset just before and read just after.
  6. profile: one more round with a move, under torch.profiler: the
     card's kernel time and its top kernels; then two rounds without the
     parity mode (timing only).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
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
MAIN_N_PACKED = 513024        # SP2 checkpoint's packed delta buffer
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


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS_PER_S * 1e3
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


def phase_build():
    from repro_torch.kernels import native
    secs = native.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in native.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": ptxas})


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


def phase_kernels():
    timed, checks = [], []
    for residual in (False, True):
        timed += check_codec(MAIN_N_PACKED, residual, timed=True)
        checks += check_codec(1000003, residual, timed=False)
    timed.append(check_fedavg(4, VGG5_PARAMS, timed=True))
    checks.append(check_fedavg(4, 1000003, timed=False))
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
    if min(launches.values()) < 1 or launches["fedavg_agg"] != 3:
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


def phase_profile(sched, round_wall_s: float):
    """One more round (pi3_1 moving back mid-round) under torch.profiler:
    the card's kernel time against the unprofiled round wall time (the
    profiler slows the host), and the kernels that take the most device
    time. Then two rounds without the parity mode, to see what it costs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.mobility import MobilityTrace, move_at_round
    from repro_torch.device import set_parity_mode
    trace = MobilityTrace(move_at_round("pi3_1", "edge-B", "edge-A", 3, 0.5))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run_round(3, trace, mode="fedfly")
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    kernel_ms = sum(r[1] for r in rows) / 1e3
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
          "top_device": [{"name": k[:90], "ms": t / 1e3, "count": c}
                         for k, t, c in rows[:12]],
          "round_wall_s_without_parity_mode": walls})


SOURCES = {"quantize_packed": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                               "src/repro/kernels/int8_codec/int8_codec.py:87"),
           "dequantize_packed": ("src/repro_torch/kernels/csrc/int8_codec.cu",
                                 "src/repro/kernels/int8_codec/int8_codec.py:121"),
           "fedavg_agg": ("src/repro_torch/kernels/csrc/fedavg_agg.cu",
                          "src/repro/kernels/fedavg_agg/fedavg_agg.py:68")}


def main() -> int:
    smi = phase_environment()
    phase_build()
    timed = phase_kernels()
    phase_quickstart()
    launches, sched, round_wall_s = phase_main_path()
    phase_profile(sched, round_wall_s)
    kernels = []
    for c in timed:
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
            "wrapper_call_ms": c["wrapper_call_ms"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
