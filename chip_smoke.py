#!/usr/bin/env python3
"""Smoke run of foundationdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `foundationdb_tpu_torch/kernels/
csrc` and runs four phases, failing (non-zero exit, no result line) on
any fault:

1. environment: the card's fingerprint and `nvidia-smi` name / power;
2. kernels: every kernel entry on seeded random inputs at the bench
   shapes (65,536-txn batches, 8-byte keys, 786,432-row tiers), held
   exactly against its plain PyTorch version on the same CUDA tensors,
   and timed beside its bound, the plain version and, where one exists,
   a single PyTorch call computing the same function;
3. the main path at full width: a 65,536-txn skiplist-style stream
   through `make_conflict_set(cfg, "cuda")`, launch counts reset just
   before and read just after; the first compact_interval + 1 batches
   must be field-for-field identical to the plain path on the CPU;
4. a reduced-shape stream (2,048 txns) through `resolve()` that must
   match the copied ConflictOracle verdict for verdict.

The last three lines are the kernel ledger (JSON), the card's name and
power limit, and `{"ok": true, "device": {...}}`. Exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: no int32 rate is published; the float32 non-tensor-core rate stands in
OPS_PER_S = 67e12

B = 65_536                  # txns, reads and writes per batch
M = 786_432                 # main and delta tier capacity (12 x B)
KEY_BYTES = 8
W = KEY_BYTES // 4 + 1
WINDOW = 1_000_000
VERSION_STEP = 200_000
SNAPSHOT_LAG = 400_000
KEYSPACE = 1_000_000
COMPACT_INTERVAL = 8
N_BATCHES = 24


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds per call of fn() between two CUDA events: the
    device time plus any gap the host leaves between the launches."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_time_by_name(fn) -> dict:
    """{kernel name: device microseconds} of what fn() launches, from
    torch.profiler (kernels, memsets and copies on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        out[ev.key] = out.get(ev.key, 0.0) + t
    return out


def device_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call of fn(): the summed duration of
    the work it puts on the card, without the host's launch gaps."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    total_us = sum(device_time_by_name(many).values())
    if total_us <= 0:
        fail("the profiler recorded no device time")
    return total_us / 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact(name: str, got, want) -> float:
    """Fail unless equal; the max absolute error (0) for the ledger."""
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max |diff| {int(diff.max())}, "
             f"{int((diff != 0).sum())} elements)")
    return 0.0


# ---------------------------------------------------------------------------
# inputs made from a seeded generator, on the card

def random_sorted_keys(gen, n_live: int, cap: int, device):
    """[cap, W] sorted distinct 8-byte keys (up to n_live of them, drawn
    from [0, 2^40)) with a sentinel tail; returns (keys, live count)."""
    import torch

    from foundationdb_tpu_torch.ops import keys as K

    raw = torch.randint(0, 1 << 40, (int(n_live * 1.1),), generator=gen,
                        device=device)
    raw = torch.unique(raw)[:n_live]
    keys = K.sentinel_like(cap, W, device)
    keys[: raw.shape[0]] = int_keys(raw)
    return keys, raw.shape[0]


def int_keys(v):
    """int64 [N] (0 <= v < 2^63) -> [N, 3] packed 8-byte big-endian keys
    (int32 bit patterns)."""
    import torch

    hi = (v >> 32) & 0xFFFFFFFF
    lo = v & 0xFFFFFFFF
    ln = torch.full_like(v, KEY_BYTES)
    words = torch.stack([hi, lo, ln], dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def phase_kernels(device) -> dict:
    """Every kernel entry vs its plain version at bench shapes, timed."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K
    from foundationdb_tpu_torch.ops import rangemax, segtree

    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    ledger = {}

    def entry(name, kern, plain, n_bytes, n_ops, library=None, check=None):
        got, want = kern(), plain()
        err = (check or exact)(name, got, want)
        if kernels.COUNTS[name] <= 0:
            fail(f"{name}: no launch counted")
        t_k = device_ms(kern)
        t_call = event_ms(kern)
        t_p = device_ms(plain, reps=3)
        t_l = device_ms(library) if library is not None else None
        b, by = bound_ms(n_bytes, n_ops)
        ledger[name] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                            bound_ms=b, bound_by=by, library_ms=t_l)
        log(f"  {name:18s} device {t_k * 1e3:9.1f} us (per call with launch "
            f"gaps {t_call * 1e3:9.1f} us)  bound {b * 1e3:7.1f} us ({by})  "
            f"plain {t_p * 1e3:10.1f} us  library "
            + (f"{t_l * 1e3:.1f} us" if t_l is not None else "none"))

    steps = M.bit_length()
    # -- A.search at its main-path shape: K6's W=1 left search of the
    #    segment ids 0..B+1 into B nondecreasing read txn ids
    ids = torch.sort(torch.randint(0, B + 1, (B,), generator=gen,
                                   device=device)).values.to(torch.int32)
    segs = torch.arange(B + 2, dtype=torch.int32, device=device)
    ids2, segs2 = ids.reshape(-1, 1), segs.reshape(-1, 1)
    entry("keysearch.search",
          lambda: K.searchsorted(ids2, segs2, side="left"),
          lambda: K.searchsorted_plain(ids2, segs2, side="left"),
          n_bytes=(B + 2 * (B + 2)) * 4,
          n_ops=(B + 2) * (B.bit_length() + 1),
          library=lambda: torch.searchsorted(ids, segs, side="left"))
    # the lexicographic W=3 search, both sides, against main-sized keys
    main_keys, n_main = random_sorted_keys(gen, 3 * M // 4, M, device)
    q_raw = torch.randint(0, 1 << 40, (B,), generator=gen, device=device)
    q = int_keys(q_raw)
    q[: B // 4] = main_keys[torch.randint(0, n_main, (B // 4,), generator=gen,
                                          device=device)]
    for side in ("left", "right"):
        exact(f"keysearch.search W={W} {side}",
              K.searchsorted(main_keys, q, side=side),
              K.searchsorted_plain(main_keys, q, side=side))

    # -- B: the main tier's max table, and the fixpoint's min table
    ver = torch.randint(-5_000_000, 5_000_000, (M,), generator=gen,
                        device=device, dtype=torch.int32)
    levels = rangemax._num_levels(M)
    entry("rangemax_build",
          lambda: rangemax.build(ver, op="max"),
          lambda: rangemax.build_plain(ver, op="max"),
          n_bytes=(1 + levels) * M * 4, n_ops=(levels - 1) * M)
    leaves = 4 * B
    mw = torch.randint(0, B, (leaves,), generator=gen, device=device,
                       dtype=torch.int32)
    exact("rangemax_build min", rangemax.build(mw, op="min"),
          rangemax.build_plain(mw, op="min"))

    # -- A.query: the fixpoint's min query over the 2^18-leaf table
    mtab = rangemax.build_plain(mw, op="min")
    lo = torch.randint(0, leaves, (B,), generator=gen, device=device,
                       dtype=torch.int32)
    span = torch.randint(-2, 64, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    hi = (lo + span).clamp(0, leaves)
    entry("keysearch.query",
          lambda: rangemax.query(mtab, lo, hi, op="min"),
          lambda: rangemax.query_plain(mtab, lo, hi, op="min"),
          n_bytes=B * 4 * 5, n_ops=B * 8)
    exact("keysearch.query max", rangemax.query(mtab, lo, hi, op="max"),
          rangemax.query_plain(mtab, lo, hi, op="max"))

    # -- A.probe: the main-tier probe of one batch's reads (most span
    #    many segments, far past the JAX 4-boundary window)
    tab = rangemax.build_plain(ver, op="max")
    rb = q
    step = torch.randint(1, 1 << 30, (B,), generator=gen, device=device)
    re = int_keys(q_raw + step)
    re[: B // 4] = main_keys[torch.randint(0, n_main, (B // 4,),
                                           generator=gen, device=device)]
    lo_k = torch.where(K.lex_less(re, rb)[:, None], re, rb)
    hi_k = torch.where(K.lex_less(re, rb)[:, None], rb, re)
    rb, re = lo_k.contiguous(), hi_k.contiguous()
    hist = H.VersionHistory(main_keys, ver, H.VERSION_NEG,
                            torch.zeros((), dtype=torch.bool, device=device))
    touched = min(M * W, 2 * B * steps * W)
    entry("keysearch.probe",
          lambda: H.query_reads_vmax(hist, rb, re, tab),
          lambda: H.query_reads_vmax_plain(main_keys, tab, rb, re),
          n_bytes=touched * 4 + B * W * 4 * 2 + B * 4 + 2 * B * 4,
          n_ops=2 * B * steps * W)

    # -- C: the fixpoint's writer cover at 2^18 leaves
    wlo = torch.randint(0, leaves, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    wlen = torch.randint(-1, 8, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    wlen[: B // 64] = torch.randint(0, leaves, (B // 64,), generator=gen,
                                    device=device, dtype=torch.int32)
    whi = wlo + wlen
    wval = torch.randint(0, B, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    wval[::3] = rangemax.INT32_POS
    log_l = leaves.bit_length() - 1
    entry("min_cover",
          lambda: segtree.min_cover(leaves, wlo, whi, wval),
          lambda: segtree.min_cover_plain(leaves, wlo, whi, wval),
          n_bytes=3 * B * 4 + leaves * 4,
          n_ops=2 * B + 2 * log_l * leaves)

    # -- D: the compaction fold (main (+) delta at M + M rows) ...
    main_val = torch.randint(0, 3_000_000, (M,), generator=gen, device=device,
                             dtype=torch.int32)
    main_val[n_main:] = H.VERSION_NEG
    d_keys, n_d = random_sorted_keys(gen, M // 3, M, device)
    d_val = torch.randint(2_000_000, 4_000_000, (M,), generator=gen,
                          device=device, dtype=torch.int32)
    d_val[n_d:] = H.VERSION_NEG
    floor = 2_500_000
    entry("merge_maps",
          lambda: H.merge_maps(main_keys, main_val, d_keys, d_val,
                               floor=floor, capacity=M),
          lambda: H.merge_maps_plain(main_keys, main_val, d_keys, d_val,
                                     floor=floor, capacity=M),
          n_bytes=3 * M * (W + 1) * 4,
          n_ops=2 * M * 4 * (M.bit_length() + 1) * W,
          check=lambda name, got, want: max(
              exact(name + " keys", got[0], want[0]),
              exact(name + " ver", got[1], want[1]),
              exact(name + " count", got[2], want[2])))
    # ... and the batch merge (delta (+) the committed-write coverage)
    cw = torch.rand((B,), generator=gen, device=device) < 0.97
    cov_keys, cov_val = G._coverage(rb, re, cw, 4_000_000)
    got = H.merge_maps(d_keys, d_val, cov_keys, cov_val, floor=floor,
                       capacity=M)
    want = H.merge_maps_plain(d_keys, d_val, cov_keys, cov_val, floor=floor,
                              capacity=M)
    for part, g, w in zip(("keys", "ver", "count"), got, want):
        exact(f"merge_maps delta+coverage {part}", g, w)
    return ledger


# ---------------------------------------------------------------------------
# the main path

def bench_config(n: int):
    from foundationdb_tpu_torch.config import KernelConfig

    return KernelConfig(
        max_key_bytes=KEY_BYTES, max_txns=n, max_reads=n, max_writes=n,
        history_capacity=12 * n, delta_capacity=12 * n,
        window_versions=WINDOW, fixpoint_unroll=3,
        compact_interval=COMPACT_INTERVAL,
    )


def verdict_fields(out) -> dict:
    return {f: getattr(out, f).cpu() for f in out._fields}


def phase_stream(device) -> dict:
    """The full-width stream; returns what the ledger needs."""
    import torch

    from foundationdb_tpu_torch import interop, kernels, make_conflict_set
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch

    cfg = bench_config(B)
    rng = np.random.default_rng(0)
    batches = [
        skiplist_style_batch(rng, cfg, B, version=(i + 1) * VERSION_STEP,
                             keyspace=KEYSPACE, snapshot_lag=SNAPSHOT_LAG,
                             key_bytes=KEY_BYTES)
        for i in range(N_BATCHES)
    ]
    cs = make_conflict_set(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_counts()
    n_cmp = COMPACT_INTERVAL + 1
    per_batch, gpu_outs, occupancy = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        out = cs.resolve_packed(b)
        torch.cuda.synchronize()
        per_batch.append(time.perf_counter() - t0)
        gpu_outs.append(verdict_fields(out))
        occupancy.append([int(c) for c in D.boundary_counts(cs.state)])
        if i == n_cmp - 1:
            gpu_state = interop.tiered_state_to_numpy(cs.state)
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated(device)
    cs.check_overflow()
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name}: not launched on the main path")
    log(f"  {N_BATCHES} batches x {B} txns; launches on the main path: "
        f"{launches}")

    # the CPU plain path on the first compact_interval + 1 batches
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t0 = time.perf_counter()
    for i, b in enumerate(batches[:n_cmp]):
        want = verdict_fields(cpu.resolve_packed(b))
        for f, v in want.items():
            if not torch.equal(gpu_outs[i][f], v):
                fail(f"batch {i}: field {f} differs from the CPU plain path")
    cpu_s = time.perf_counter() - t0
    cpu_state = interop.tiered_state_to_numpy(cpu.state)
    for tier, got, want in zip(("main", "delta"), gpu_state, cpu_state):
        for part, g, w in zip(("keys", "ver", "oldest", "overflow"), got, want):
            if not np.array_equal(g, w):
                fail(f"after batch {n_cmp - 1}: {tier} {part} differs from "
                     "the CPU plain path")
    log(f"  first {n_cmp} batches (one compaction inside) identical to the "
        f"CPU plain path, field by field, and both tiers identical row for "
        f"row after them ({cpu_s:.1f} s on the CPU)")

    steady = per_batch[n_cmp:]
    ms = statistics.median(steady) * 1e3
    committed = [int(o["committed_count"]) for o in gpu_outs]
    conflicts = [int(o["conflict_count"]) for o in gpu_outs]
    fx = cs.metrics.fixpoint
    log(f"  steady state: {ms:.3f} ms/batch median over batches "
        f"{n_cmp}..{N_BATCHES - 1}, {B / (ms / 1e3):,.0f} txn/s; "
        f"all batches: {[round(t * 1e3, 2) for t in per_batch]} ms")
    log(f"  committed/batch {committed}; conflicts/batch {conflicts}")
    log(f"  fixpoint: {fx.applications} applications over {fx.batches} "
        f"batches (max {fx.max_applications}/batch, "
        f"{fx.loop_iterations} host-loop iterations past the unroll of "
        f"{cfg.fixpoint_unroll})")
    log(f"  tier occupancy (live rows) after each batch, (main, delta): "
        f"{occupancy} of ({cfg.history_capacity}, {cfg.delta_capacity}); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    log(f"  compactions {cs.metrics.counters['compactions']}")
    prof = profile_batches(cs, batches, device, ms)
    return dict(launches=launches, ms_per_batch=ms, profile=prof)


def profile_batches(cs, batches, device, wall_ms: float) -> dict:
    """Device time by kernel over two more batches (torch.profiler): the
    device's busy and idle share against the unprofiled wall time per
    batch, and the share of the library sorts and scans."""
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch

    cfg = cs.config
    rng = np.random.default_rng(1)
    base = int(batches[-1].version)
    extra = [skiplist_style_batch(rng, cfg, B,
                                  version=base + (i + 1) * VERSION_STEP,
                                  keyspace=KEYSPACE,
                                  snapshot_lag=SNAPSHOT_LAG,
                                  key_bytes=KEY_BYTES) for i in range(2)]

    def run():
        for b in extra:
            cs.resolve_packed(b)

    by_name = device_time_by_name(run)
    total = sum(by_name.values()) / 1e3 / len(extra)   # ms per batch
    if total <= 0:
        fail("the profiler recorded no device time for the stream")
    lib = sum(t for k, t in by_name.items()
              if any(s in k.lower() for s in ("sort", "radix", "scan")))
    lib_ms = lib / 1e3 / len(extra)
    log(f"  profiler over 2 batches: device busy {total:.3f} ms/batch of "
        f"{wall_ms:.3f} ms wall (idle share {1 - total / wall_ms:.3f}); "
        f"library sort/scan {lib_ms:.3f} ms/batch = "
        f"{lib_ms / total:.3f} of device time")
    for k, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        log(f"    {t / 1e3 / len(extra):9.3f} ms/batch  {k[:100]}")
    return {"device_ms_per_batch": total, "idle_share": 1 - total / wall_ms,
            "sort_scan_ms_per_batch": lib_ms,
            "sort_scan_share_of_device": lib_ms / total}


def phase_oracle(device) -> None:
    """2,048-txn stream through resolve(): verdicts and conflict reports
    identical to the copied ConflictOracle."""
    from foundationdb_tpu_torch import make_conflict_set
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch
    from foundationdb_tpu_torch.utils.packing import unpack_key

    n = 2048
    cfg = bench_config(n).scaled(compact_interval=3)
    rng = np.random.default_rng(7)
    cs = make_conflict_set(cfg, "cuda")
    oracle = make_conflict_set(cfg, "cpu")
    n_conflict = 0
    for i in range(8):
        # versions start past the snapshot lag: commit versions and read
        # snapshots are non-negative, as the oracle's background 0 assumes
        pb = skiplist_style_batch(rng, cfg, n,
                                  version=SNAPSHOT_LAG + (i + 1) * VERSION_STEP,
                                  keyspace=20_000, range_len=3,
                                  snapshot_lag=SNAPSHOT_LAG,
                                  key_bytes=KEY_BYTES)
        txns = [
            CommitTransaction(
                read_conflict_ranges=[(unpack_key(pb.read_begin[t]),
                                       unpack_key(pb.read_end[t]))],
                write_conflict_ranges=[(unpack_key(pb.write_begin[t]),
                                        unpack_key(pb.write_end[t]))],
                read_snapshot=int(pb.snapshot[t]),
                report_conflicting_keys=bool(t % 2),
            )
            for t in range(n)
        ]
        got = cs.resolve(txns, int(pb.version))
        want = oracle.resolve(txns, int(pb.version))
        if got.verdicts != want.verdicts:
            fail(f"oracle batch {i}: verdicts differ")
        if got.conflicting_key_ranges != want.conflicting_key_ranges:
            fail(f"oracle batch {i}: conflicting key ranges differ")
        n_conflict += sum(int(v) == 0 for v in got.verdicts)
    if n_conflict == 0:
        fail("oracle stream produced no conflicts; it checks nothing")
    log(f"  8 batches x {n} txns identical to ConflictOracle "
        f"({n_conflict} conflicts)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from foundationdb_tpu_torch import device as devmod
    from foundationdb_tpu_torch import kernels

    t_start = time.perf_counter()
    device = devmod.resolve_device()
    log("== 1. environment")
    fp = devmod.fingerprint(device)
    log("  " + json.dumps(fp))
    log("== build")
    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, text in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log("== 2. kernels vs plain versions (bench shapes)")
    ledger = phase_kernels(device)
    log("== 3. full-width stream")
    stream = phase_stream(device)
    log("== 4. reduced-shape stream vs ConflictOracle")
    phase_oracle(device)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, info in kernels.KERNELS.items():
        rows.append(dict(name=name, route="cuda", source=info.source,
                         replaces=info.replaces,
                         launches=stream["launches"][name], **ledger[name]))
    print(json.dumps({"stream": {"ms_per_batch": stream["ms_per_batch"],
                                 "txn_per_s": B / stream["ms_per_batch"] * 1e3,
                                 **stream["profile"]}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(devmod.nvidia_smi_name_power(device.index or 0), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
