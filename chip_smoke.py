#!/usr/bin/env python3
"""Smoke run of foundationdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --build-cover   # kernels B and C alone, timed
    python3 chip_smoke.py --merge         # kernel D alone, timed
    python3 chip_smoke.py --probe-fold    # kernels A's probe and H alone
    python3 chip_smoke.py --short-span    # kernel K's application alone
    python3 chip_smoke.py --queries       # kernels A's query and G alone
    python3 chip_smoke.py --searches      # kernels A's search and E alone
    python3 chip_smoke.py --writes-radix4 # K16 and kernel M, with B, C, D

Builds the hand-written kernels from `foundationdb_tpu_torch/kernels/
csrc` and runs these phases, failing (non-zero exit, no result line) on
any fault:

1. environment: the card's fingerprint and `nvidia-smi` name / power;
2. kernels: every kernel entry on seeded inputs at the bench shapes
   (65,536-txn batches, 8-byte keys, 786,432-row tiers; kernel E over a
   group of 8 YCSB-E batches, kernel F over a zipf batch, kernels G and
   H over the 2,097,152-rank endpoint space of a group of 8 uniform
   batches, kernels I and J at a group of 8 uniform batches on 4
   shards, kernels N (the radix sort) and L over a uniform batch's
   262,144 endpoint rows, N also over a zipf batch's 65,536 x 6 dedup
   rows, 131,072 coverage rows and a group of 8's 2,097,152 rows, kernel
   D's merge_writes entry (its row-keeping mode, one launch) at 655,360
   + 131,072 rows and kernel M (B and C at radix 4, and its query, one
   launch each) at 262,144 leaves and 65,536 queries, the reference
   scripts' shapes, and both exact, one launch a call, on every case of
   testing/writes_cases),
   held exactly
   against its plain PyTorch version on the same CUDA tensors, and
   timed beside its bound, the plain version and, where one exists, a
   single PyTorch call computing the same function; kernel B also timed
   at the fixpoint's 2^18 leaves (min), kernel D at the compaction's
   786,432 + 786,432 rows and the batch merge's 786,432 + 131,072; B, C
   and D one launch a call, B and C held exactly at the sizes about
   their tiles (1 .. 786,432 rows, 1 .. 2^20 leaves with intervals of
   every level), D on every case of testing/merge_cases at W = 3 and 5
   (live rows about its tiles, a 5,000-row run across two tile edges,
   all-sentinel maps, a capacity under the count, each hard part again
   past 600,000 real rows, where it takes its 2,048-position tiles);
   first the fixpoint's read spans of every batch of the uniform,
   hot-key and range-scan streams are surveyed (`read_spans` in the
   streams' JSON: what FIXPOINT_LEVELS is chosen from); kernel B also
   timed at the fixpoint's depth (`fixpoint_min_2p18_L7`) and kernel A's
   query on that table at a uniform batch's own ranks, and exact, one
   launch a call, over tables of every depth the fixpoint may take and
   the full one, min and max, on short reads and on reads up to the
   whole leaf range (its long path); kernel G's build one launch a call,
   its query at a classic group's own ranks (the `rangemax2.query` row)
   and at a synthetic mix of wide and empty ones (`synthetic_mix`);
   kernel A's probe also timed at the uniform stream's point reads
   against a main tier 3/4 live (its `uniform_point_reads` entry), the
   probe and H one launch a call and exact on every case of
   testing/probe_cases (the probe at W = 3 and 5: the fence's rows, the
   window, inverted, empty and dead reads, the tier's ends; H's inverted
   committed writes, a write over the whole space, rank n); kernel A's
   search timed left, right and both sides at the short-span classic
   path's shapes (65,536 and 524,288 read begins over a 786,432-row tier
   of the uniform keyspace, both sides of a group of 8's 2,097,152
   distinct point keys; the `keysearch.search` row is the 524,288 left
   search, the rest its `shapes`), its counts entry at K6's shape, and
   the search, the counts, E and the probe exact, one launch a call, on
   every case of testing/search_cases (W = 1 .. 8) and E on the probe's
   cases;
3. the uniform stream at full width: 65,536-txn skiplist-style batches
   through `make_conflict_set(cfg, "cuda")` (whose constructor runs the
   rangemax self-check, timed), launch counts reset just before and
   read just after; the first 5 batches must be field-for-field
   identical to the plain path on the CPU;
4. the hot-key stream (bench `zipf`): groups of 8 zipf-1.1 batches with
   the fixpoint latch and read dedup, every field identical to the
   exact configuration on the card, the first group to the CPU plain
   path; then a dedup cap under the stream's distinct count, so every
   group trips and falls back, with the same results;
5. the range-scan stream (bench `ycsb_e`): groups of 8 YCSB-E batches
   with the endpoint sweep, delta spill and the latch, every group
   identical to the probe path on the card and the first to the CPU
   plain path, the stream classified range_heavy and routed to cuda;
6. the classic uniform stream (bench `BENCH_KERNEL=classic`, no delta
   tier): the uniform batches in groups of 8 through the group kernel
   with its cross-batch phase (kernels G and H), every field identical
   to the same batches one at a time (`resolve_batch`) on the card, the
   single tier identical after every group, every batch identical to
   the tiered uniform stream of phase 3, group 0 to the CPU plain path;
   each of G = 8 and G = 1 profiled over one more group or batch;
7. the classic hot-key stream (bench `BENCH_KERNEL=classic
   BENCH_MODE=zipf`: the latch, unroll 8, groups of 8): identical to the
   exact classic config on the card, and a forced-trip run (unroll 1)
   whose groups fall back with the same results; one more group
   profiled;
8. the wire Resolver role's default shape (16-byte keys, 1,024 txns,
   4,096 reads and writes, a 65,536-row tier, no delta tier) through
   `resolve()`, verdicts and conflict reports identical to the copied
   ConflictOracle, with p50 / p99 ms per batch; one more batch profiled;
9. the sharded uniform stream: four resolvers on the card over the
   keyspace quartiles (`n_shards=4`, 786,432-row tiers each), 3 groups
   of 8 uniform batches, exact, every field identical to four
   independent single-shard conflict sets fed batches clipped by this
   script's numpy clip and combined here with numpy, each shard's tiers
   identical to its own set's after every group (kernels I and J
   launched); then 2 groups of 8 YCSB-E batches at 4 shards with sweep +
   spill + latch, identical to the probe path on the card, and a
   forced-trip group (the latch at unroll 1) that falls back on every
   shard with the exact run's results;
10. the short-span streams: the widest live span of the uniform stream
   (tiered and classic groups of 8) sets S, the smallest power of two
   >= 4 at or above it; kernel K held to its plain version at the
   uniform batch's shapes (the range op over the tier; one fixpoint
   application, `ss_apply`, one launch, exact again three applications
   in a row after its timing's hundreds of launches on the same cover);
   the uniform stream at S tiered (24 batches),
   classic (3 groups of 8) and on 4 shards (1 group), every field and
   tier identical to the same batches at S = 0 on the card (phases 3, 6
   and 9), batch or group 0 to the CPU plain path, kernels K and L
   launched and C and G not, kernel E once a tiered batch and once a
   classic group, A's search twice a classic group (the cross span)
   and on no other path; a YCSB-E group of 2 at S must raise
   HistoryOverflowError (and does not at S = 0);
11. a reduced-shape contended stream (2,048 txns) through `resolve()`,
   exact, latched + dedup, sweep + spill, classic (one batch at a
   time, and groups of 4 through `resolve_group_args`) and sharded at 2
   and 4 shards: each must match the copied ConflictOracle (the sharded
   ones the copied MultiResolverOracle) verdict for verdict.
12. the staging pipeline: phase 3's uniform batches through
   `resolve_stream_pipelined` (chunks of 8, depth 2: a staging thread
   stacks each chunk into a pinned slab and copies it on a copy stream)
   and phase 6's classic groups of 8 through `resolve_group_stream`, on
   fresh sets, every field identical to phases 3 and 6; each beside the
   same batches one by one (pageable copies) on a fresh set, then, warm,
   3 rounds of 16 batches replayed later in time, staged and one by one
   in turns; a profiled staged run that must show pinned host-to-device
   copies and no pageable one; the bytes each call of
   `interop.device_args_to_torch` copies on each path; one copy of each
   shape timed pageable (also after a 256 MiB host write) and pinned;
   and `stage_ledger` at the bench shapes (fuse 8);
13. the Resolver role: at the wire shape (phase 8's config), 64 chained
   requests from two proxies through `Resolver(backend="cuda")` on the
   card, one carrying a state transaction (which must reach the other
   proxy) and one replayed as a duplicate (answered from the cache),
   every verdict and conflict report identical to phase 8's (the copied
   ConflictOracle's), p50 / p99 a request; at full width, 8 requests of
   65,536 txns (a point read and write over 1M 8-byte keys) through the
   knob-routed backend (`backend=None`, which must build the card's
   TorchConflictSet), identical to a bare TorchConflictSet on the card
   and, the first 2, to the CPU plain path (the copied oracle takes
   minutes a batch at that size), p50 / p99 a request beside the bare
   `resolve()`'s;
14. the wire resolver: four port resolver processes
   (`cluster/multiprocess.spawn_role`, backend "cuda"), spawned at once
   once the kernels are built, each reached over a Unix socket and
   failing the phase at once if it exits. WC (the wire role's default
   config): phase 8's 64 batches as columnar frames, chained, identical
   to phase 8's verdicts and reports, a duplicate answered from the
   reply cache, a stale-epoch request refused, its status showing 64
   columnar batches, 128 copies and phase 8's kernel launches, each as
   often; then the same batches as object frames past the window,
   identical again, with the same launches. W2 (two such processes): the
   batches clipped to the keyspace halves (`default_resolver_boundaries(2)`,
   then the middle of phase 8's keys) and min-combined here, identical
   to the copied MultiResolverOracle, each child launching phase 8's
   kernels and the fixed-per-batch ones phase 8's count a request. WF
   (phase 13's full-width config through RESOLVER_KERNEL): phase 13's 8
   requests as columnar frames, identical to phase 13's replies, with
   phase 13's launches. It
   prints each child's seconds from spawn to first answer and its
   warm-up, the round trips (p50 / p99) beside phases 8 and 13, the
   roles' compute time, the proxy's pack_columnar + encode and the
   role's decode + pack_batch_columnar ms, `path_stats` and the
   children's kernel launches.
15. the commit path: three port processes (`spawn_role`: a "cuda"
   resolver on the card at `commit_config()`, the tiered path at 4,096
   txns with 16-byte keys, through RESOLVER_KERNEL; a tlog and a
   storage, each on a data dir of its own, the memory engine) under the
   port's ProxyPipeline in this process (max_batch 4,096, 1 ms batch
   interval), driven through get_read_version, read and commit: YCSB's
   load (100,000 records of ten 100-byte fields, one insert a
   transaction, in a seeded order), then workload A (256 clients x 40
   operations, half reads, half read-modify-write updates of a counter
   field with read and write conflict ranges, retried up to 8 times on
   a conflict, zipfian 0.99 over the records). It fails unless every
   resolver reply (recorded by a thin subclass of the connection) is
   the copied ConflictOracle's on the requests replayed in version
   order, the storage snapshot at the last committed version is the
   replay of the committed mutations, every record's counter is its
   committed updates, every tlog push is its batch's committed
   mutations and the tlog holds the pushes past its last pop, no batch
   failed, and the resolver child launched the card's kernels, A's
   counts and probe, L and N phase 3's count a batch (the same tiered
   path) times its batches and D one a batch and one a compaction. It
   prints the cut, the load's seconds, the committed and conflicted
   updates and the abort share, commits a second, commit p50 / p99,
   GRV and read p50, batches and their mean size, the resolver's
   compute p50, its launches a batch and each child's seconds from
   spawn to first answer, each beside the card's name and power limit.
16. the simulated cluster: `open_cluster` (two commit proxies, two
   resolvers, four storage servers in teams of two, two log replicas;
   the resolver boundary at the middle of the records' keys, the storage
   boundaries at their quartiles) with `commit_config()` and both
   resolvers' tiers on the card, driven on its Scheduler(sim=True)
   through `Database` transactions. (a) One short seed (5,000 records,
   64 clients x 10 ops) twice in this process, the resolvers "cuda" on
   the card and "cpu" (the host oracle): identical transaction
   outcomes, reads, storage snapshots, log replicas' durable records
   and final virtual time. (b) Phase 15's traffic (YCSB's load from
   4,096 loader tasks through `Database.run`, then workload A, 256
   clients x 40 ops) at as many of its 100,000 records as (a)'s load
   rate does in 0.4 of the phase's 150 s budget (the cut is printed):
   it fails unless both resolvers are TorchConflictSets on the card,
   each resolver's replies are the copied ConflictOracle's on its
   requests replayed in version order, `check_cluster` passes, every
   record on both replicas of its team is the replay of the committed
   mutations and each counter its committed updates, A's counts and
   probe, L and N launched phase 3's count a batch over both resolvers'
   batches (an empty batch, the clipped txns of the other resolver's
   keys or an idle proxy's, is dispatched like any other) and D one
   more a compaction, and after `cluster.stop()` no actor error is
   unhandled and the live-task count is back to its value before boot.
   It prints the load's and the workload's wall and virtual seconds,
   commits a second on the wall and in virtual time, the abort share,
   the resolvers' compute p50 / p99 a batch (each conflict set's
   resolve() call), the share of the wall inside those calls, and
   batches and their mean size, beside the card's name and power limit.
17. the wire cluster under its controller (cell LC): first, in this
   process, a ResolverRole(backend="cuda", epoch=2) on the card at
   tests/test_lifecycle.py's small RESOLVER_KERNEL decides that test's
   in-flight set after the conservative recovery batch as the port's
   sim recovery does. Then `python -m foundationdb_tpu_torch.cluster.
   monitor` starts the controller and 10 workers; the controller
   recruits 2 tlogs, 1 storage, the sequencer, 2 resolvers (on the card
   at `commit_config()`), a ratekeeper and 2 proxies onto them, and
   phase 15's traffic runs from ClusterClients in this process (YCSB's
   load, every insert offered at once, then workload A, 256 clients x
   40 ops). At half of workload
   A's operations acknowledged, the worker hosting resolver1 is
   SIGKILLed: the monitor restarts it and the controller recovers into
   a newer generation with both resolvers recruited anew on the card.
   It fails unless each recruited resolver, before and after the kill,
   is a TorchConflictSet on the card whose own launches are phase 3's
   count a dispatched batch; the generation advances and its recovery
   version is above the last commit acknowledged before the kill; no
   committed transaction (each recorded at the client) read a key
   another wrote at a version in (its read snapshot, its commit
   version]; every abort has a cause (a write to its key at a version
   in (its read snapshot, a read version taken after the reply], or a
   recovery in that interval; for TOO_OLD a snapshot past the window);
   every acknowledged insert is in the storage role's
   snapshot at a fresh version (a sample also through the front door)
   with each counter between its acknowledged increments and those plus
   its unknown outcomes; a read at a snapshot from before the kill
   aborts; no process but the killed worker exits, none is left after
   the monitor stops, and the whole takes at most 240 s. It prints the
   time to the first commit, the load's and the workload's wall and
   commits a second, the abort share, commit p50 / p99 at the client,
   the kill to the new generation's first commit (detection, the
   recovery walk, the new resolvers' warm-up), and each resolver's
   batches, mean batch size and compute p50 / p99.
18. the simulation ensemble on the card (cell EN): the soak seeds that
   draw the device backend (EN_SEEDS: the classic, tiered + read dedup,
   2-shard and sweep + spill kernels, with backup_restore and
   knob_quorum among their faults) each through
   `testing/soak.run_seed` on the card at its spec's own shape, every
   gate of the seed passing; EN_RERUN again and EN_TRACED with the
   span-chain, census and status-probe gates; the saturation ramp
   (quick, admission on) and the hotspot gate's sim legs (zipf,
   uniform), in EN_CARD_WORKERS spawned processes that share the card.
   Meanwhile EN_WORKERS more run each of them with device="cpu" (the
   plain versions). It fails unless every
   signature and report equals its plain-version twin, the rerun is
   identical, every resolver of every epoch is a TorchConflictSet on the
   card, every kernel of each resolver's path (`en_kernels`: the K15
   chain, F with read dedup, E with the sweep, I and J on 2 shards)
   launched in each run, no card process's allocated memory after its
   repeated runs is above its level after its first pass, and the phase
   takes at most EN_BUDGET_S (240 s). It prints each run's wall (and its
   twin's), commits, aborts, epoch, batches, launches by kernel and
   allocated memory, and the phase's wall, beside the card's name and
   power limit.
19. the features beside the commit path (cell FX): five legs, each on
   `open_cluster` clusters whose resolvers are TorchConflictSets on the
   card at `commit_config()`: DR (a DrAgent replicating a source under
   YCSB's load of 100,000 records and workload A into a locked
   destination, a plain write there refused, the switchover's
   destination equal to the source at the takeover version, every
   acknowledged write read back from it); multi-region (satellite logs,
   a RemoteDC fed by the log router under 20,000 inserts, the router cut
   off, the primary DC killed, `failover()` at RPO 0); the metacluster
   (24 tenants over two data clusters by capacity, each with 1,000
   records and workload A through its Tenant handle, isolation checked,
   a non-empty delete refused); backup into a BlobStoreContainer served
   on 127.0.0.1, ParallelRestore at 4 appliers into a fresh cluster
   (6,000 records: an applier commits its shard in one transaction) and
   blob granules read equal to the storage at two versions; the HCA
   under 32 clients, 1,000 TaskBucket tasks each run once, and
   CliSession's status, set/get, tenant, backup and restore. Each leg
   runs at its twin size (FX_TWIN, `fx_twin_config()`) and at full size
   in FX_CARD_WORKERS spawned processes on the card while FX_WORKERS
   more run the twins with device="cpu". It fails on any leg's check,
   unless every twin's digest (results, storage snapshots, virtual time,
   unhandled errors, probes hit) equals its plain versions', unless every
   run's launches are phase 3's chain a batch, and unless the phase takes
   at most FX_BUDGET_S (180 s). It prints each run's wall, commits a
   second, the DR apply rate, lag at the switchover and switchover wall,
   the failover's wall, batches, launches a batch and device memory
   peak, beside the card's name and power limit.

20. the sealed commit path over mutual TLS and tenant tokens (cell SE):
   leg A is phase 15's commit path (`phase_commit_path`, the same
   resolver child on the card, YCSB's load of 100,000 records and
   workload A) with the tlog and the storage sealed (`encrypt=True`,
   their keys from the port's stub REST KMS through FDB_TPU_KMS), every
   connection of the parent and the children mutual TLS under a PKI from
   the port's `make_test_tls` (FDB_TPU_TLS_DIR; the parent's
   environment restored after), and the storage killed with SIGKILL at
   half of workload A and started again on its data dir. It fails
   unless phase 15's checks hold (every reply the oracle's, the
   snapshot the replay, phase 3's chain of launches), the restarted
   storage's snapshot at the last acknowledged version is the replay
   and its keys came from the KMS by id, no file of either data dir
   holds the sentinel or any of SE_SAMPLES loaded values, a role opened
   there without encryption is refused, a plaintext client is refused,
   every parent connection was a TLS handshake with the peer's
   certificate and the stub KMS answered exactly the children's
   fetches. Leg B opens `open_cluster` (resolvers on the card at
   `commit_config()`) with a TokenVerifier on `cluster.token_verifier`:
   8 tenants x 1,000 records each committed under its own signed token,
   then for every tenant a short-lived token allowed before its expiry
   and five denials (no token, another tenant's, a forged, the expired
   one on the scheduler's clock, malformed claims), each raising
   PermissionDeniedError and committing nothing; the same leg at its
   twin size runs on the card and on the plain versions, digests equal,
   the decision counts equal at both sizes. It prints load and workload
   commits a second, commit p50 / p99, read p50, the seal and open us a
   record in the storage child, the TLS handshakes and phase 15's
   numbers beside them, beside the card's name and power limit, and
   fails past SE_BUDGET_S (150 s).

The last lines are the streams' numbers (JSON; phases 12, 13, 14, 15,
16, 17, 18, 19 and 20 under `pipelined_uniform`, `pipelined_classic`,
`staging`, `resolver`, `wire`, `commit_path`, `sim_cluster`,
`wire_cluster`, `ensemble`, `features` and `sealed`),
the kernel ledger (JSON), the card's name and power limit, and `{"ok":
true, "device": {...}}`. Exits non-zero without a result when no CUDA device is present.

With `--build-cover` it builds the kernels and times only kernels B and
C at the resolver path's shapes (`time_build_cover`), with `--merge`
only kernel D at its two (`time_merge`), with `--probe-fold` only kernel
A's probe at its two and kernel H (`time_probe_fold`), with
`--short-span` only one short-span fixpoint application
(`time_short_span`), with `--queries` only the exact fixpoint's min
table and query (kernels B and A's query) at every level and at each
depth the fixpoint may take, and kernel G's build and query
(`time_queries`), with `--searches` only kernel A's search at the
short-span classic path's shapes, K6's counts, kernel E, A's probe and
one short-span classic group of 8 (`time_searches`), with
`--writes-radix4` only K16 and kernel M's build, query and cover at
phase 2's shapes, then B and C as `--build-cover` and D as `--merge`
times them (`time_writes_radix4`), printing their JSON and the card's
name and power limit.
"""

from __future__ import annotations

import functools
import json
import os
import re
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
#: uniform batches the CPU plain path repeats in phase 3 (the CPU checks
#: are most of the script's time; compaction is held to its plain
#: version in phase 2 and card to card in phases 3, 6 and 10)
N_CPU_CHECK = 5
N_BATCHES = 24
GROUP = 8                   # batches per fused dispatch (bench BENCH_FUSE)
ZIPF = 1.1
ZIPF_KEYSPACE = 10_000_000
ZIPF_BATCHES = 16
ZIPF_UNROLL = 8
TRIP_U = 16_384             # a dedup cap under the zipf stream's count
YCSB_GROUPS = 4
YCSB_UNROLL = 14
SHARDS = 4                  # resolvers of the sharded stream, on one card
SHARD_GROUPS = 3            # uniform groups of 8 through the shards
SHARD_YCSB_GROUPS = 2
# the wire ResolverRole's default KernelConfig (cluster/multiprocess.py
# of the JAX package) and its MVCC window
ROLE_TXNS = 1024
ROLE_RANGES = 4096
ROLE_KEY_BYTES = 16
ROLE_HISTORY = 1 << 16
ROLE_WINDOW = 5_000_000
ROLE_BATCHES = 64
ROLE_KEYSPACE = 20_000
ROLE_VERSION_STEP = 100_000


#: the script's start on the host clock
T_START = time.perf_counter()


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


#: a profiler record of one of the port's kernels: its demangled name
#: starts with the kernel's own, in the sources' unnamed namespace
PORT_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")


@functools.lru_cache(maxsize=None)
def port_kernel_names() -> frozenset:
    """The __global__ functions of the port's kernel sources."""
    from foundationdb_tpu_torch import kernels

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)")
    return frozenset(name for src in kernels.SOURCES for name in
                     pat.findall((kernels.CSRC / f"{src}.cu").read_text()))


#: Each profiler session opens with a host op and WARM_KERNELS short
#: spin kernels, idles SESSION_PAD_S, runs LATE_KERNELS more spin kernels
#: and fn(), and idles SESSION_PAD_S again (the spin kernels are left out
#: of its results). On the card's machine a session can lose its first
#: device records: Kineto counts them "Out-of-range" of the session's
#: window (shown with KINETO_LOG_LEVEL=0). What is lost is a prefix in
#: time that grows through a run (1 .. 9 of the opening spin kernels over
#: one run; all 64, four sessions in a row, 80 s into another), so one
#: spin kernel on record, of either set, shows that fn()'s records are
#: whole; the late ones, after the idle pad, stay on record while the
#: lost prefix is shorter than the pad
WARM_KERNELS = 64
LATE_KERNELS = 8
SESSION_PAD_S = 0.02


def device_time_by_name(fn) -> tuple:
    """({kernel name: device microseconds} of what fn() launches, from
    torch.profiler (kernels, memsets and copies on the card); {kernel
    function: records} of the session's launches of the port's kernels;
    the spin kernels on record, opening and late)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ours = port_kernel_names()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1)
        for _ in range(WARM_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(SESSION_PAD_S)
        for _ in range(LATE_KERNELS):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
        time.sleep(SESSION_PAD_S)
        torch.zeros(1)
    out, n_ours, n_spin = {}, {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in ev.key:
            n_spin += ev.count
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        out[ev.key] = out.get(ev.key, 0.0) + t
        m = PORT_KERNEL.match(ev.key)
        if m and m.group(1) in ours:
            n_ours[m.group(1)] = n_ours.get(m.group(1), 0) + ev.count
    return out, n_ours, n_spin


#: the profiler sessions taken again: what each recorded against the
#: launches counted over it
RETAKES = []
#: the spin kernels lost, one entry per session that lost any
WARM_LOST = []


def profiled(fn) -> dict:
    """device_time_by_name(fn), held to what kernels.COUNTS counted over
    the same session: the profiler's records of the port's kernels must
    number exactly the launches counted, one of the spin kernels at least
    must be on record, and the session must record some device
    work. A session that fails is taken again (logged, and
    kept in RETAKES), up to four sessions in all; then the script
    fails."""
    from foundationdb_tpu_torch import kernels

    for attempt in range(4):
        before = dict(kernels.COUNTS)
        by_name, records, n_spin = device_time_by_name(fn)
        per_entry = {k: n - before[k] for k, n in kernels.COUNTS.items()
                     if n != before[k]}
        recorded, launched = sum(records.values()), sum(per_entry.values())
        busy = sum(by_name.values())
        if n_spin < WARM_KERNELS + LATE_KERNELS:
            WARM_LOST.append(WARM_KERNELS + LATE_KERNELS - n_spin)
        if recorded == launched and n_spin > 0 and busy > 0:
            return by_name
        RETAKES.append(dict(recorded=recorded, launched=launched,
                            spin_recorded=n_spin, device_us=busy,
                            at_s=time.perf_counter() - T_START))
        log(f"    (profiler session {attempt + 1}, "
            f"{RETAKES[-1]['at_s']:.1f} s in: {recorded} records of the "
            f"port's kernels for {launched} launches, {n_spin} of "
            f"{WARM_KERNELS + LATE_KERNELS} spin kernels, {busy:.1f} us of "
            "device time; "
            f"launched by entry {per_entry}, recorded by kernel "
            f"{records})")
    fail("four profiler sessions in a row disagree with the launch "
         f"counts: {RETAKES[-4:]}")


def device_ms(fn, reps: int = 10, sessions: int = 1) -> float:
    """Mean device milliseconds per call of fn(): the summed duration of
    the work it puts on the card, without the host's launch gaps, from
    checked profiler sessions (`profiled`); with `sessions` > 1 the
    median over that many."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    return statistics.median(sum(profiled(many).values()) / 1e3 / reps
                             for _ in range(sessions))


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


def measure(ledger: dict, name: str, kern, plain, *,
            n_bytes: float, n_ops: float, library=None, check=None,
            detail: bool = False, key: str = None) -> None:
    """One kernel entry's ledger row (under `key`, else its name):
    kern() against plain() (exact unless `check` says otherwise), the
    launches of one call, the device time, the per-call time with launch
    gaps, the plain version's and the library call's time, and the bound
    from n_bytes and n_ops."""
    from foundationdb_tpu_torch import kernels

    before = kernels.COUNTS[name]
    got = kern()
    per_call = kernels.COUNTS[name] - before
    want = plain()
    err = (check or exact)(name, got, want)
    if per_call <= 0:
        fail(f"{name}: no launch counted")
    t_k = device_ms(kern, sessions=3)
    t_call = event_ms(kern)
    t_p = device_ms(plain, reps=3)
    t_l = device_ms(library, sessions=3) if library is not None else None
    b, by = bound_ms(n_bytes, n_ops)
    ledger[key or name] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                               bound_ms=b, bound_by=by, library_ms=t_l,
                               launches_per_call=per_call)
    log(f"  {key or name:18s} device {t_k * 1e3:9.1f} us (per call with launch "
        f"gaps {t_call * 1e3:9.1f} us)  bound {b * 1e3:7.1f} us ({by})  "
        f"plain {t_p * 1e3:10.1f} us  library "
        + (f"{t_l * 1e3:.1f} us" if t_l is not None else "none"))
    if detail:   # the wrapper's device work by kernel, one call
        for k, t in sorted(profiled(kern).items(),
                           key=lambda kv: -kv[1]):
            log(f"      {t:8.1f} us  {k[:90]}")


def phase_kernels(device, zipf_batch, ycsb_group, dedup_u: int,
                  uniform_group) -> dict:
    """Every kernel entry vs its plain version at bench shapes, timed.

    Kernel F (read_dedup) takes the reads of one zipf batch, kernel E
    (sweep_ranks) the reads of one group of YCSB-E batches, and kernels
    G and H (rangemax2, seg_fold) the group-wide endpoint ranks of a
    group of 8 uniform batches: the inputs the hot-key, range-scan and
    classic paths give them."""
    import torch

    from foundationdb_tpu_torch import interop, kernels
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K
    from foundationdb_tpu_torch.ops import rangemax, segtree

    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    ledger = {}

    def entry(name, kern, plain, n_bytes, n_ops, **kw):
        measure(ledger, name, kern, plain, n_bytes=n_bytes, n_ops=n_ops,
                **kw)

    steps = M.bit_length()
    # -- A.counts at its main-path shape: K6's offsets of the segment ids
    #    0..B+1 over B nondecreasing read txn ids, one launch
    ids = torch.sort(torch.randint(0, B + 1, (B,), generator=gen,
                                   device=device)).values.to(torch.int32)
    segs = torch.arange(B + 2, dtype=torch.int32, device=device)
    entry("keysearch.counts",
          lambda: G._sorted_counts(ids, B + 1),
          lambda: G._sorted_counts_plain(ids, B + 1),
          n_bytes=(B + B + 2) * 4, n_ops=B,
          library=lambda: torch.searchsorted(ids, segs, side="left"))
    # -- A.search at the short-span classic path's shapes, W = 3 over a
    #    786,432-row tier: left, right and both sides
    search_rows(ledger, *search_inputs(gen, uniform_group, device))
    search_edge_checks(device)
    main_keys, n_main = random_sorted_keys(gen, 3 * M // 4, M, device)
    q_raw = torch.randint(0, 1 << 40, (B,), generator=gen, device=device)
    q = int_keys(q_raw)
    q[: B // 4] = main_keys[torch.randint(0, n_main, (B // 4,), generator=gen,
                                          device=device)]

    # -- B: the main tier's max table, and the fixpoint's min table (its
    #    row carries the second shape), one launch a call at each
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
    levels_f = rangemax._num_levels(leaves)
    entry("rangemax_build",
          lambda: rangemax.build(mw, op="min"),
          lambda: rangemax.build_plain(mw, op="min"),
          n_bytes=(1 + levels_f) * leaves * 4, n_ops=(levels_f - 1) * leaves,
          key="rangemax_build min 2^18")
    ledger["rangemax_build"]["fixpoint_min_2p18"] = ledger.pop(
        "rangemax_build min 2^18")
    tile_edge_checks(gen, device)

    # -- B at the fixpoint's depth, and A.query: the fixpoint's min
    #    table and query at a uniform batch's own ranks and writes, then
    #    exact over a full table (min and max) and on reads up to the
    #    whole leaf range (the long path)
    fix = fixpoint_inputs(gen, uniform_group[0], device)
    fmw, flo, fhi = fixpoint_cover(fix), fix[4], fix[5]
    depth = G.FIXPOINT_LEVELS
    entry("rangemax_build",
          lambda: rangemax.build(fmw, op="min", levels=depth),
          lambda: rangemax.build_plain(fmw, op="min", levels=depth),
          n_bytes=(1 + depth) * leaves * 4, n_ops=(depth - 1) * leaves,
          key="rangemax_build min fixpoint")
    ledger["rangemax_build"][f"fixpoint_min_2p18_L{depth}"] = ledger.pop(
        "rangemax_build min fixpoint")
    ftab = rangemax.build(fmw, op="min", levels=depth)
    entry("keysearch.query",
          lambda: rangemax.query(ftab, flo, fhi, op="min"),
          lambda: rangemax.query_plain(ftab, flo, fhi, op="min"),
          n_bytes=query_bytes(depth, leaves, flo, fhi), n_ops=B * 8)
    query_checks(gen, mw, device)

    # -- A.probe: the main-tier probe of one batch's reads (most span
    #    many segments, far past the JAX 4-boundary window), and the
    #    uniform stream's point reads against a main-sized tier
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
    probe_rows(ledger, (hist, tab, rb, re),
               uniform_point_reads(gen, uniform_group[0], device))

    # -- C: the fixpoint's writer cover at 2^18 leaves
    wlo, whi, wval = writer_cover(gen, leaves, device)
    entry("min_cover",
          lambda: segtree.min_cover(leaves, wlo, whi, wval),
          lambda: segtree.min_cover_plain(leaves, wlo, whi, wval),
          **cover_bound(leaves))

    # -- D: the compaction fold (main (+) delta at M + M rows) and the
    #    batch merge (delta (+) the committed-write coverage), one launch
    #    a call, and exact at the shapes about its tiles
    main_val = torch.randint(0, 3_000_000, (M,), generator=gen, device=device,
                             dtype=torch.int32)
    main_val[n_main:] = H.VERSION_NEG
    d_keys, n_d = random_sorted_keys(gen, M // 3, M, device)
    d_val = torch.randint(2_000_000, 4_000_000, (M,), generator=gen,
                          device=device, dtype=torch.int32)
    d_val[n_d:] = H.VERSION_NEG
    cw = torch.rand((B,), generator=gen, device=device) < 0.97
    cov_keys, cov_val = G._coverage(rb, re, cw, 4_000_000)
    merge_rows(ledger, (main_keys, main_val), (d_keys, d_val),
               (cov_keys, cov_val))
    for name in ("rangemax_build", "min_cover", "merge_maps",
                 "keysearch.probe"):
        if ledger[name]["launches_per_call"] != 1:
            fail(f"{name}: {ledger[name]['launches_per_call']} launches a "
                 "call, not one")
    merge_edge_checks(device)

    # -- E: one group's main-tier ranks, against a main tier dense in the
    #    YCSB keyspace, so both ends tie with main boundaries often
    sweep_main, srb, sre, srv = sweep_inputs(gen, ycsb_group, device)
    r, live = srb.shape[0], int(srv.sum())
    entry("sweep_ranks",
          lambda: D.sweep_read_ranks(sweep_main, srb, sre, srv),
          lambda: D.sweep_read_ranks_plain(sweep_main, srb, sre, srv),
          n_bytes=sweep_bytes(sweep_main, srb, sre, srv),
          n_ops=2 * live * steps * W, check=exact_parts)
    ledger["sweep_ranks"]["bound_ms_whole_tier"] = bound_ms(
        2 * r * W * 4 + r + M * W * 4 + 2 * r * 4, 0)[0]

    # -- F: one zipf batch's reads, the dedup cap the stream sizes, and a
    #    cap under the distinct count (the tripping case)
    dk = torch.unique(torch.randint(0, ZIPF_KEYSPACE, (M,), generator=gen,
                                    device=device))[: 3 * M // 4]
    dkeys = K.sentinel_like(M, W, device)
    dkeys[: dk.shape[0]] = int_keys(dk)
    dhist = H.VersionHistory(dkeys, ver, H.VERSION_NEG,
                             torch.zeros((), dtype=torch.bool, device=device))
    args = zipf_batch.device_args()
    zrb, zre, zrv = (interop.to_torch(args[k], device)
                     for k in ("read_begin", "read_end", "read_valid"))
    rows = D.dedup_rows(zrb, zre, zrv)
    n_uniq = None
    for u in (TRIP_U, dedup_u):
        got = D.dedup_vmax(dhist, tab, zrb, zre, zrv, u)
        want = D.dedup_vmax_plain(dkeys, tab, rows, u)
        exact_parts(f"read_dedup U={u}", got, want)
        n_uniq = int(got[1])
    nr = zrb.shape[0]
    pairs = np.concatenate([args["read_begin"][args["read_valid"]],
                            args["read_end"][args["read_valid"]]], axis=1)
    if n_uniq != len(np.unique(pairs, axis=0)):
        fail(f"read_dedup: n_uniq {n_uniq} is not numpy's distinct count")
    log(f"  read_dedup input: {nr} reads, {n_uniq} distinct live (begin, "
        f"end) rows (numpy agrees); U = {dedup_u} and {TRIP_U} (trips)")
    touched = min(M * W, 2 * n_uniq * steps * W)
    entry("read_dedup",
          lambda: D.dedup_vmax(dhist, tab, zrb, zre, zrv, dedup_u),
          lambda: D.dedup_vmax_plain(dkeys, tab, rows, dedup_u),
          n_bytes=2 * nr * W * 4 + nr + touched * 4 + 2 * n_uniq * 4
          + nr * 4,
          n_ops=2 * W * nr + 2 * n_uniq * steps * W,
          library=lambda: torch.unique(rows, dim=0, return_inverse=True),
          check=exact_parts)

    # -- G and H: the cross-batch phase of a classic group of 8 uniform
    #    batches, over its group-wide endpoint ranks (2G(NR+NW) rows)
    ranks, n_map = group_ranks(uniform_group, device)
    g_rows(ledger, gen, ranks, n_map, device)
    if ledger["rangemax2.build"]["launches_per_call"] != 1:
        fail(f"rangemax2.build: "
             f"{ledger['rangemax2.build']['launches_per_call']} launches a "
             "call, not one")
    # every build's last block set its stream's arrival counter back to 0,
    # so the next build on that stream starts from 0
    held = [int(a.item()) for a in rangemax._BUILD2_ARRIVE.values()]
    if not held or any(held):
        fail(f"rangemax2.build: arrival counters {held} after its calls, "
             "not 0")
    fold_row(ledger, gen, ranks, n_map)
    if ledger["seg_fold"]["launches_per_call"] != 1:
        fail(f"seg_fold: {ledger['seg_fold']['launches_per_call']} launches "
             "a call, not one")
    probe_fold_edge_checks(device)

    # -- I and J: the sharded path's clip and combine at a group of 8
    #    uniform batches on 4 shards split at the keyspace quartiles
    from foundationdb_tpu_torch.parallel import sharding as SH

    ug = interop.device_args_to_torch(groups_of(uniform_group)[0], device)
    plo, phi = SH.partition_tensors(quartiles(), bench_config(B), device)

    def fields(name, got, want):
        if isinstance(want, dict):
            return max(exact(f"{name} {k}", got[k], want[k]) for k in want)
        return max(exact(f"{name} {f}", getattr(got, f), getattr(want, f))
                   for f in want._fields)

    live = SH.clip_batch_plain(ug, plo, phi)["read_valid"].sum(dim=(1, 2))
    log(f"  shard_clip input: {GROUP} uniform batches of {B} reads and "
        f"writes, {SHARDS} shards at the quartiles; live reads per shard "
        f"{live.tolist()}")
    rows = 2 * GROUP * B
    entry("shard_clip",
          lambda: SH.clip_batch(ug, plo, phi),
          lambda: SH.clip_batch_plain(ug, plo, phi),
          n_bytes=clip_bytes(SHARDS, W, GROUP, B, B, B),
          n_ops=rows * SHARDS * 5 * W, check=fields)
    # J: the shape the combine gets on that path, verdict codes and first
    # indices drawn at random (a tenth of txns with an intra hit)
    codes = torch.tensor([0, 1, 3], dtype=torch.int32, device=device)
    jv = codes[torch.randint(0, 3, (SHARDS, GROUP, B), generator=gen,
                             device=device)]
    jf = torch.randint(0, B, (SHARDS, GROUP, B), generator=gen,
                       device=device, dtype=torch.int32)
    jf[torch.rand((SHARDS, GROUP, B), generator=gen, device=device) < 0.9] = -1
    jh = torch.rand((SHARDS, GROUP, B), generator=gen, device=device) < 0.01
    jo = torch.zeros((SHARDS, GROUP), dtype=torch.bool, device=device)
    jt = torch.zeros((SHARDS,), dtype=torch.bool, device=device)
    jt[1] = True
    jargs = (jv, jf, jh, jo, jt, ug["txn_valid"])
    entry("shard_combine",
          lambda: SH.combine(*jargs),
          lambda: SH.combine_plain(*jargs),
          n_bytes=combine_bytes(SHARDS, GROUP, B, B),
          n_ops=SHARDS * GROUP * 3 * B, check=fields)

    # -- N: the lexicographic sort of one uniform batch's 262,144 endpoint
    #    rows, dead rows masked (what sort_ranks hands it on every path);
    #    held exactly at the dedup rows' width, the coverage sort's rows and
    #    a classic group of 8's 2,097,152 rows too
    a0 = interop.device_args_to_torch(uniform_group[0].device_args(), device)
    pts = torch.cat([a0["read_begin"], a0["read_end"], a0["write_begin"],
                     a0["write_end"]]).contiguous()
    pvalid = torch.cat([a0["read_valid"], a0["read_valid"],
                        a0["write_valid"], a0["write_valid"]])
    p = pts.shape[0]
    masked = torch.where(pvalid[:, None], pts, K.SENTINEL_WORD).contiguous()
    log(f"  lex_order input: {p} x {W}-word rows, {radix_passes(masked)} of "
        f"{4 * W} digits not constant over the live rows")
    entry("lex_order",
          lambda: K.lex_sort_perm(masked),
          lambda: K.lex_sort_perm_plain(masked),
          n_bytes=p * (2 * W * 4 + 4), n_ops=p * 4 * W, check=exact_parts,
          detail=True)
    ends = torch.cat([torch.where(cw[:, None], rb, K.SENTINEL_WORD),
                      torch.where(cw[:, None], re, K.SENTINEL_WORD)])
    group_pts = group_points(uniform_group, device)
    for tag, x in (("dedup rows", D.dedup_rows(zrb, zre, zrv)),
                   ("coverage ends", ends), ("group of 8", group_pts)):
        exact_parts(f"lex_order {tag} {tuple(x.shape)}", K.lex_sort_perm(x),
             K.lex_sort_perm_plain(x))
        log(f"  lex_order {tag} {tuple(x.shape)}: {radix_passes(x)} of "
            f"{4 * x.shape[1]} digits not constant; device "
            f"{device_ms(lambda: K.lex_sort_perm(x), sessions=3) * 1e3:.1f}"
            f" us, the plain sort "
            f"{device_ms(lambda: K.lex_sort_perm_plain(x), reps=3) * 1e3:.1f}"
            " us")

    # -- L: sort_ranks over the same rows (the reference's
    #    profile_serialized.py shape)
    ucount = int(K.sort_ranks_plain(pts, pvalid)[2])
    log(f"  sort_ranks input: {p} x {W}-word endpoint rows of a uniform "
        f"batch, {int(pvalid.sum())} valid, {ucount} distinct")
    entry("sort_ranks",
          lambda: K.sort_ranks(pts, pvalid),
          lambda: K.sort_ranks_plain(pts, pvalid),
          n_bytes=p * (2 * W * 4 + 4 + 1) + 4,
          n_ops=p * W * (p.bit_length() - 1),
          library=lambda: torch.unique(masked, dim=0, return_inverse=True),
          check=exact_parts, detail=True)

    # -- K16 on D's row-keeping mode and kernel M (B and C at radix 4):
    #    the reference scripts' shapes, then every case of
    #    testing/writes_cases, one launch a call
    writes_radix4_rows(ledger, gen, device)
    for name in OFF_PATH:
        if ledger[name]["launches_per_call"] != 1:
            fail(f"{name}: {ledger[name]['launches_per_call']} launches a "
                 "call, not one")
    writes_edge_checks(device)
    return ledger


#: kernel B's and C's sizes about their 4,096-row tiles: one row, a tile
#: less one, one, one more, past 16 tiles, the fixpoint's leaves, a tier
#: the depths the fixpoint's min table was chosen from (FIXPOINT_LEVELS)
LEVEL_CHOICES = (6, 7, 8, 10, 13)
#: reads of up to the whole leaf range in kernel A's query checks (the
#: plain version gathers each one's 2^18 / 2^(L-1) entries)
LONG_READS = 4096
TILE_EDGE_ROWS = (1, 3, 4095, 4096, 4097, 65_537, 262_144, M)
TILE_EDGE_LEAVES = (1, 64, 4096, 8192, 1 << 18, 1 << 20)


def cover_intervals(gen, leaves: int, n: int, device):
    """[n] lo, hi, val for kernel C: intervals of every level at random
    starts, ones that straddle every 4,096-leaf boundary, full-width ones
    (one from lo < 0 to hi > leaves), the rest short or as wide as the
    leaves, lo from -4; a fifth of the values INT32_POS."""
    import torch

    from foundationdb_tpu_torch.ops import rangemax

    def rand(lo, hi, k):
        return torch.randint(lo, hi, (k,), generator=gen, device=device)

    log = leaves.bit_length() - 1
    lo = rand(-4, leaves + 4, n)
    length = torch.cat([rand(-2, 300, n // 2), rand(-2, leaves + 8,
                                                    n - n // 2)])
    span = 1 << torch.arange(log + 1, device=device)
    lo[:log + 1] = (torch.rand(log + 1, generator=gen, device=device)
                    * (leaves - span + 1)).long()
    length[:log + 1] = span
    edges = torch.arange(4096, max(leaves, 4096), 4096, device=device)
    lo[log + 1:log + 1 + edges.numel()] = edges - 3
    length[log + 1:log + 1 + edges.numel()] = 7
    lo[-3:] = torch.tensor([0, -5, -3], device=device)
    length[-3:] = torch.tensor([leaves, leaves + 10, 4], device=device)
    val = rand(0, n, n)
    val[::5] = rangemax.INT32_POS
    return (lo.to(torch.int32), (lo + length).to(torch.int32),
            val.to(torch.int32))


def query_bytes(levels: int, m: int, lo, hi) -> int:
    """Kernel A's query's byte floor: each query's ends and answer (12 B)
    and 4 B a distinct table entry it reads: none where its range is
    empty, one where its span is a power of two up to 2^levels (both
    lookups read t[k][lo]), two at other spans up to 2^levels, and
    ceil(span / 2^(levels - 1)) level-(levels - 1) entries past that
    (the long path)."""
    import torch

    span = (hi.to(torch.int64).clamp(0, m)
            - lo.to(torch.int64).clamp(0, m)).clamp(min=0)
    half = 1 << (levels - 1)
    pow2 = (span & (span - 1)) == 0
    entries = torch.where(span > 2 * half, (span - 1) // half + 1,
                          torch.where(pow2, 1, 2))
    return 12 * lo.shape[0] + 4 * int(torch.where(span > 0, entries,
                                                  0).sum())


def query_checks(gen, values, device) -> None:
    """Kernel A's query exact against its plain version over tables of
    values ([2^18] int32) at every depth the fixpoint may take and the
    full one, min and max: reads of -2 .. 64 leaves (empty, inverted,
    clipped) and reads up to the whole leaf range (the long path, past
    2^L), one launch a call."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import rangemax

    m = values.shape[0]

    def ints(lo, hi, n=B):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    lo, lo_w = ints(-3, m + 3), ints(-3, m // 2, LONG_READS)
    short, wide = lo + ints(-2, 64), lo_w + ints(0, m + 4, LONG_READS)
    # the whole range, past both ends, empty and inverted at the ends
    ends = torch.tensor([[0, m], [-5, m + 3], [0, 0], [m, m - 1], [1, m]],
                        dtype=torch.int32, device=device)
    lo_w[:ends.shape[0]], wide[:ends.shape[0]] = ends[:, 0], ends[:, 1]
    long_n = 0
    for levels in (*LEVEL_CHOICES, None):
        for op in ("min", "max"):
            tab = rangemax.build(values, op=op, levels=levels)
            for what, a, b in (("short", lo, short), ("long", lo_w, wide)):
                before = kernels.COUNTS["keysearch.query"]
                got = rangemax.query(tab, a, b, op=op)
                if kernels.COUNTS["keysearch.query"] != before + 1:
                    fail("keysearch.query: not one launch a call")
                exact(f"keysearch.query L={tab.shape[0]} {op} {what}", got,
                      rangemax.query_plain(tab, a, b, op=op))
            long_n += int(((wide.clamp(0, m) - lo_w.clamp(0, m))
                           > (1 << tab.shape[0])).sum())
    log(f"  keysearch.query over {m} values at L = {LEVEL_CHOICES} and "
        f"full, min and max: exact on {B} reads of -2 .. 64 leaves and "
        f"{LONG_READS} of up to the whole range ({long_n} long-path reads "
        "in all)")


def tile_edge_checks(gen, device) -> None:
    """Kernels B (both ops) and C at the sizes about their tiles, exact
    against their plain versions, one launch a call."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import rangemax, segtree

    def once(name, kern, plain, tag):
        before = kernels.COUNTS[name]
        got = kern()
        if kernels.COUNTS[name] - before != 1:
            fail(f"{tag}: {kernels.COUNTS[name] - before} launches, not one")
        exact(tag, got, plain())

    for m in TILE_EDGE_ROWS:
        vals = torch.randint(-10**9, 10**9, (m,), generator=gen,
                             device=device, dtype=torch.int32)
        for op in ("max", "min"):
            once("rangemax_build", lambda: rangemax.build(vals, op=op),
                 lambda: rangemax.build_plain(vals, op=op),
                 f"rangemax_build {op} m={m}")
    for leaves in TILE_EDGE_LEAVES:
        lo, hi, val = cover_intervals(gen, leaves, 5000, device)
        once("min_cover", lambda: segtree.min_cover(leaves, lo, hi, val),
             lambda: segtree.min_cover_plain(leaves, lo, hi, val),
             f"min_cover leaves={leaves}")
    log(f"  rangemax_build at m in {TILE_EDGE_ROWS} (max, min) and "
        f"min_cover at leaves in {TILE_EDGE_LEAVES}: exact, one launch each")


def merge_bound(ra: int, rb: int, cap: int, w: int = W) -> dict:
    """Kernel D's bound inputs: the ra + rb real rows of the two maps
    read once (a sentinel tail is found by one search and never read)
    and every output row written once, 4 (ra + rb + cap) (w + 1) bytes;
    about four w-word compares a real row's merged position (the merge
    step, the run-end check, the run's ends)."""
    return dict(n_bytes=4 * (ra + rb + cap) * (w + 1),
                n_ops=4 * (ra + rb) * w)


def real_rows(keys) -> int:
    """The rows of a sorted map before its sentinel tail (last word not
    all ones), counted on the host."""
    return int((keys[:, -1] != -1).sum())


def merge_rows(ledger: dict, main, delta, cov, floor: int = 2_500_000,
               ) -> None:
    """Kernel D timed at its two shapes on the path: the compaction fold
    (main (+) delta, M + M rows, the `merge_maps` row) and the batch merge
    (delta (+) a batch's coverage, M + 2B rows, its `batch_merge`
    entry), each exact against its plain version (keys, values, count),
    each bound at its inputs' real rows."""
    from foundationdb_tpu_torch.ops import history as H

    def parts(name, got, want):
        return max(exact(name + " keys", got[0], want[0]),
                   exact(name + " ver", got[1], want[1]),
                   exact(name + " count", got[2], want[2]))

    for key, (a, b) in (("merge_maps", (main, delta)),
                        ("merge_maps batch merge", (delta, cov))):
        ra, rb = real_rows(a[0]), real_rows(b[0])
        log(f"  {key}: {ra:,} + {rb:,} real rows of "
            f"{a[0].shape[0]:,} + {b[0].shape[0]:,}")
        measure(ledger, "merge_maps",
                lambda: H.merge_maps(*a, *b, floor=floor, capacity=M),
                lambda: H.merge_maps_plain(*a, *b, floor=floor, capacity=M),
                **merge_bound(ra, rb, M), check=parts, key=key)
        ledger[key]["real_rows"] = [ra, rb]
    ledger["merge_maps"]["batch_merge"] = ledger.pop("merge_maps batch merge")


def merge_edge_checks(device) -> None:
    """Kernel D exact against its plain version on every case of
    testing/merge_cases (live rows about its tiles up to a 786,432-row
    tier, a 5,000-row run across two tile edges, keys shared at every
    edge, the coverage's runs, every value under the floor, a capacity
    under the count; the run, the shared keys and the capacity again past
    600,000 real rows, where it takes its 2,048-position tiles) at W = 3
    and 5, one launch a call."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.testing import merge_cases as MC

    for name in MC.NAMES:
        for w in (3, 5):
            c = MC.case(name, w)
            args = [torch.from_numpy(x).to(device) for x in c[:4]]
            before = kernels.COUNTS["merge_maps"]
            got = H.merge_maps(*args, floor=c.floor, capacity=c.capacity)
            if kernels.COUNTS["merge_maps"] - before != 1:
                fail(f"merge_maps {name} W={w}: "
                     f"{kernels.COUNTS['merge_maps'] - before} launches")
            want = H.merge_maps_plain(*args, floor=c.floor,
                                      capacity=c.capacity)
            for part, g, x in zip(("keys", "ver", "count"), got, want):
                exact(f"merge_maps {name} W={w} {part}", g, x)
    log(f"  merge_maps on {len(MC.NAMES)} edge cases at W = 3 and 5: "
        "exact, one launch each")


def writer_cover(gen, leaves: int, device) -> tuple:
    """Kernel C's input at its phase-2 shape: [B] lo, hi, val of the
    fixpoint's writes over `leaves` (-1 .. 7 leaves wide, a 64th up to
    the whole width; a third of the values INT32_POS)."""
    import torch

    from foundationdb_tpu_torch.ops import rangemax

    wlo = torch.randint(0, leaves, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    wlen = torch.randint(-1, 8, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    wlen[: B // 64] = torch.randint(0, leaves, (B // 64,), generator=gen,
                                    device=device, dtype=torch.int32)
    wval = torch.randint(0, B, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    wval[::3] = rangemax.INT32_POS
    return wlo, wlo + wlen, wval


def cover_bound(leaves: int) -> dict:
    """Kernel C's bound inputs at B intervals: lo, hi and val read once
    and the leaves written once; two atomics an interval and a min a leaf
    a level."""
    return dict(n_bytes=3 * B * 4 + leaves * 4,
                n_ops=2 * B + 2 * (leaves.bit_length() - 1) * leaves)


def writes_input(gen, device) -> tuple:
    """K16's input at the reference's shape (profile_serialized.py's 655K +
    131K): a tier of 655,360 live rows of M, 131,072 run bounds (an eighth
    equal to tier keys), version 1,200,000, floor 200,000."""
    import torch

    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K

    n_runs = M // 6                        # 131,072 at bench shape
    wt_keys, n_wt = random_sorted_keys(gen, M - n_runs, M, device)
    wt_ver = torch.randint(0, 1_000_000, (M,), generator=gen, device=device,
                           dtype=torch.int32)
    wt_ver[n_wt:] = H.VERSION_NEG
    fresh = torch.randint(0, 1 << 40, (n_runs,), generator=gen,
                          device=device)
    on_tier = torch.randint(0, n_wt, (n_runs // 8,), generator=gen,
                            device=device)
    tier_ints = ((wt_keys[on_tier, 0].to(torch.int64) & 0xFFFFFFFF) << 32) \
        | (wt_keys[on_tier, 1].to(torch.int64) & 0xFFFFFFFF)
    bounds = torch.unique(torch.cat([fresh[: n_runs - on_tier.shape[0]],
                                     tier_ints]))
    bounds = bounds[: bounds.shape[0] // 2 * 2]
    runs = K.sentinel_like(n_runs, W, device)
    runs[: bounds.shape[0]] = int_keys(bounds)
    whist = H.VersionHistory(wt_keys, wt_ver, 0, torch.zeros(
        (), dtype=torch.bool, device=device))
    log(f"  merge_writes input: {n_wt} live tier rows of {M}, "
        f"{bounds.shape[0]} run bounds "
        f"({int(torch.isin(bounds, tier_ints).sum())} equal to tier keys), "
        "version 1,200,000, floor 200,000")
    return whist, runs, n_wt + bounds.shape[0]


def history_parts(name, got, want) -> float:
    return max(exact(f"{name} keys", got.main_keys, want.main_keys),
               exact(f"{name} ver", got.main_ver, want.main_ver),
               exact(f"{name} overflow", got.overflow, want.overflow))


def writes_radix4_rows(ledger: dict, gen, device) -> None:
    """K16 and kernel M's three entries at the reference scripts' shapes
    (profile_serialized.py's 655,360 + 131,072 rows; experiments6.py's
    262,144 leaves and 65,536 queries of 1..63, 65,536 intervals), each
    held exactly to its plain version and timed (`measure`)."""
    import torch

    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import rangemax, segtree

    whist, runs, real = writes_input(gen, device)
    n_runs = runs.shape[0]
    measure(ledger, "merge_writes",
            lambda: H.merge_writes(whist, runs, 1_200_000, 200_000),
            lambda: H.merge_writes_plain(whist, runs, 1_200_000, 200_000),
            n_bytes=2 * M * (W + 1) * 4 + n_runs * W * 4,
            n_ops=4 * real * W, check=history_parts)
    leaves4 = 4 * B                         # 262,144 at bench shape
    vals4 = torch.randint(0, 1 << 30, (leaves4,), generator=gen,
                          device=device, dtype=torch.int32)
    lv4 = rangemax._num_levels4(leaves4)
    measure(ledger, "rangemax4.build",
            lambda: rangemax.build4(vals4, op="max"),
            lambda: rangemax.build4_plain(vals4, op="max"),
            n_bytes=(1 + lv4) * leaves4 * 4, n_ops=3 * (lv4 - 1) * leaves4)
    exact("rangemax4.build min", rangemax.build4(vals4, op="min"),
          rangemax.build4_plain(vals4, op="min"))
    tab4 = rangemax.build4_plain(vals4, op="max")
    q4 = B
    qlo4 = torch.randint(0, leaves4 - 1, (q4,), generator=gen, device=device,
                         dtype=torch.int32)
    qhi4 = (qlo4 + torch.randint(1, 64, (q4,), generator=gen, device=device,
                                 dtype=torch.int32)).clamp(max=leaves4)
    measure(ledger, "rangemax4.query",
            lambda: rangemax.query4(tab4, qlo4, qhi4, op="max"),
            lambda: rangemax.query4_plain(tab4, qlo4, qhi4, op="max"),
            n_bytes=q4 * 4 * 7, n_ops=q4 * 4)
    tab4n = rangemax.build4_plain(vals4, op="min")
    exact("rangemax4.query min",
          rangemax.query4(tab4n, qlo4, qhi4, op="min"),
          rangemax.query4_plain(tab4n, qlo4, qhi4, op="min"))
    ilo4 = torch.randint(0, leaves4 - 64, (q4,), generator=gen,
                         device=device, dtype=torch.int32)
    ihi4 = ilo4 + torch.randint(1, 64, (q4,), generator=gen, device=device,
                                dtype=torch.int32)
    ival4 = torch.randint(0, q4, (q4,), generator=gen, device=device,
                          dtype=torch.int32)
    nlev4 = segtree._cover4_levels(leaves4)
    measure(ledger, "rangemax4.cover",
            lambda: segtree.min_cover4(leaves4, ilo4, ihi4, ival4),
            lambda: segtree.min_cover4_plain(leaves4, ilo4, ihi4, ival4),
            n_bytes=3 * q4 * 4 + leaves4 * 4,
            n_ops=4 * q4 + 3 * (nlev4 - 1) * leaves4)
    exact("rangemax4.cover vs min_cover",
          segtree.min_cover4(leaves4, ilo4, ihi4, ival4),
          segtree.min_cover(leaves4, ilo4, ihi4, ival4))


def writes_edge_checks(device) -> None:
    """K16 (kernel D's row-keeping mode) exact against its plain version
    on every case of testing/writes_cases at W = 3 and 5 (keys, versions,
    overflow), and kernel M's build, query (max and min) and cover on its
    sizes and intervals there, one launch a call each."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import rangemax, segtree
    from foundationdb_tpu_torch.testing import writes_cases as WC

    def once(name, tag, fn):
        before = kernels.COUNTS[name]
        got = fn()
        if kernels.COUNTS[name] - before != 1:
            fail(f"{tag}: {kernels.COUNTS[name] - before} launches, not one")
        return got

    def on_card(*xs):
        return [torch.from_numpy(x).to(device) for x in xs]

    for name in WC.NAMES:
        for w in (3, 5):
            c = WC.case(name, w)
            keys, ver, runs = on_card(c.main_keys, c.main_ver, c.runs)
            state = H.VersionHistory(keys, ver, c.oldest, torch.tensor(
                c.overflow, device=device))
            tag = f"merge_writes {name} W={w}"
            got = once("merge_writes", tag, lambda: H.merge_writes(
                state, runs, c.version, c.floor))
            history_parts(tag, got, H.merge_writes_plain(
                state, runs, c.version, c.floor))
    for m in WC.BUILD_ROWS:
        vals, lo, hi = on_card(*WC.build_case(m))
        for op in ("max", "min"):
            tag = f"rangemax4 {op} m={m}"
            tab = once("rangemax4.build", tag + " build",
                       lambda: rangemax.build4(vals, op=op))
            exact(tag + " build", tab, rangemax.build4_plain(vals, op=op))
            exact(tag + " query",
                  once("rangemax4.query", tag + " query",
                       lambda: rangemax.query4(tab, lo, hi, op=op)),
                  rangemax.query4_plain(tab, lo, hi, op=op))
    for leaves in WC.COVER_LEAVES:
        lo, hi, val = on_card(*WC.cover_case(leaves))
        tag = f"rangemax4.cover leaves={leaves}"
        exact(tag, once("rangemax4.cover", tag,
                        lambda: segtree.min_cover4(leaves, lo, hi, val)),
              segtree.min_cover4_plain(leaves, lo, hi, val))
    log(f"  merge_writes on {len(WC.NAMES)} cases at W = 3 and 5, "
        f"rangemax4 build and query at m in {WC.BUILD_ROWS} (max, min) and "
        f"its cover at leaves in {WC.COVER_LEAVES}: exact, one launch each")


def uniform_point_reads(gen, batch, device) -> tuple:
    """Kernel A's probe at the uniform stream's reads: one uniform batch's
    65,536 reads ([k, k + 2) over the 1M keyspace: point reads, one or two
    tier keys apart) against a main tier 3/4 live (589,824 distinct keys
    of the same keyspace), with random versions: (hist, table, rb, re)."""
    import torch

    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K
    from foundationdb_tpu_torch.ops import rangemax

    args = batch.device_args()
    rb, re = (interop.to_torch(args[k], device).contiguous()
              for k in ("read_begin", "read_end"))
    live = torch.sort(torch.randperm(KEYSPACE + 1, generator=gen,
                                     device=device)[: 3 * M // 4]).values
    keys = K.sentinel_like(M, W, device)
    keys[: live.shape[0]] = int_keys(live)
    ver = torch.randint(0, 3_000_000, (M,), generator=gen, device=device,
                        dtype=torch.int32)
    ver[live.shape[0]:] = H.VERSION_NEG
    hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                            torch.zeros((), dtype=torch.bool, device=device))
    return hist, rangemax.build_plain(ver, op="max"), rb, re


def answer_rows(keys, *answers) -> int:
    """The distinct key rows that decide searches' answers: for each
    answer a the rows a - 1 and a within the map, which any search must
    read to know where its key falls; counted on the host."""
    import torch

    rows = torch.cat([x for a in answers for x in (a - 1, a)])
    rows = rows[(rows >= 0) & (rows < keys.shape[0])]
    return int(torch.unique(rows).numel())


def deciding_rows(keys, rb, re) -> int:
    """The distinct key rows that decide a probe's answers: those of its
    begin's right search and its end's left search (answer_rows: {il,
    il + 1, ir, ir + 1} within the map)."""
    from foundationdb_tpu_torch.ops import keys as K

    return answer_rows(keys, K.searchsorted_plain(keys, rb, side="right"),
                       K.searchsorted_plain(keys, re, side="left"))


def exact_parts(name: str, got, want) -> float:
    """exact() on a tensor, or on each of a tuple's (a both-sides search,
    kernel E's two ends)."""
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != len(want):
            fail(f"{name}: {type(got).__name__} where {len(want)} parts "
                 "were expected")
        return max(exact(f"{name} [{i}]", g, w)
                   for i, (g, w) in enumerate(zip(got, want)))
    return exact(name, got, want)


def search_inputs(gen, batches, device) -> tuple:
    """Kernel A's search at the short-span classic path's shapes: a
    786,432-row tier 3/4 live of the uniform stream's 1M keyspace (as
    uniform_point_reads makes it); the read begins of one uniform batch
    (65,536) and of a group of 8 (524,288: _block_spans' left search);
    and the group's distinct point keys (2,097,152 rows with a sentinel
    tail: its both-sides search). Returns (keys, {count: queries},
    distinct keys)."""
    import torch

    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import keys as K

    live = torch.sort(torch.randperm(KEYSPACE + 1, generator=gen,
                                     device=device)[: 3 * M // 4]).values
    keys = K.sentinel_like(M, W, device)
    keys[: live.shape[0]] = int_keys(live)
    rb = torch.cat([interop.to_torch(b.device_args()["read_begin"], device)
                    for b in batches]).contiguous()
    ukeys = K.sort_ranks(group_points(batches, device))[1]
    return keys, {B: rb[:B].contiguous(), rb.shape[0]: rb}, ukeys


def search_bound(keys, q, answers) -> tuple:
    """(bytes, operations) of a search: the queries and the key rows that
    decide their answers (answer_rows) read once, the indices written
    once; a compare of W words a step of a binary search."""
    m, w = keys.shape
    return (4 * (answer_rows(keys, *answers) * w + q.shape[0] * w
                 + len(answers) * q.shape[0]),
            len(answers) * q.shape[0] * m.bit_length() * w)


def search_rows(ledger: dict, keys, queries: dict, ukeys) -> None:
    """Kernel A's search timed at the short-span classic path's shapes
    (search_inputs), each exact against its plain version: left, right
    and both sides at each query count, and both sides of the group's
    distinct point keys. The `keysearch.search` row is the left search
    of the group's read begins (_block_spans' own); the others go under
    its `shapes`."""
    from foundationdb_tpu_torch.ops import keys as K

    cases = [(side, n, q) for n, q in queries.items()
             for side in ("left", "right", "both")]
    cases.append(("both", "distinct point keys", ukeys))
    for side, n, q in cases:
        want = K.searchsorted_plain(keys, q, side=side)
        n_bytes, n_ops = search_bound(
            keys, q, want if side == "both" else (want,))
        measure(ledger, "keysearch.search",
                functools.partial(K.searchsorted, keys, q, side=side),
                functools.partial(K.searchsorted_plain, keys, q, side=side),
                n_bytes=n_bytes, n_ops=n_ops, check=exact_parts,
                key=f"A search {side} {n}")
    row = ledger.pop(f"A search left {max(queries)}")
    row["shapes"] = {k[len("A search "):]: ledger.pop(k)
                     for k in list(ledger) if k.startswith("A search ")}
    ledger["keysearch.search"] = row


def search_edge_checks(device) -> None:
    """Kernels A's search and counts and E, and A's probe beside E, exact
    against their plain versions on every case of testing/search_cases,
    one launch a call: the search left, right and both sides at W = 1 ..
    8 (tiers of one row, in the fence, at and one past its cap, far past
    it, full, repeated rows, a sentinel tail of the window's rows;
    sentinel queries), the counts (gaps, all equal, 70,000 ids in one
    bin, none, a tile past the block's threads and bins, ids past the last
    segment, a classic group of 8's), E and the probe on each search
    case's reads (forward, inverted, empty, a tenth dead) and E on
    testing/probe_cases at W = 3 and 5."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K
    from foundationdb_tpu_torch.ops import rangemax
    from foundationdb_tpu_torch.testing import probe_cases as PC
    from foundationdb_tpu_torch.testing import search_cases as SC

    def one(name, tag, fn):
        before = kernels.COUNTS[name]
        got = fn()
        if kernels.COUNTS[name] - before != 1:
            fail(f"{tag}: {kernels.COUNTS[name] - before} launches, not one")
        return got

    def sweep_and_probe(tag, keys, rb, re, live):
        exact_parts(f"sweep_ranks {tag}", one(
            "sweep_ranks", tag, lambda: D.sweep_read_ranks(keys, rb, re,
                                                           live)),
            D.sweep_read_ranks_plain(keys, rb, re, live))
        ver = torch.randint(0, 10**6, (keys.shape[0],), device=device,
                            dtype=torch.int32)
        tab = rangemax.build_plain(ver, op="max")
        hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                                torch.zeros((), dtype=torch.bool,
                                            device=device))
        exact(f"keysearch.probe {tag}", one(
            "keysearch.probe", tag,
            lambda: H.query_reads_vmax(hist, rb, re, tab)),
            H.query_reads_vmax_plain(keys, tab, rb, re))

    for name in SC.SEARCH_NAMES:
        for w in SC.WIDTHS:
            keys, q = (torch.from_numpy(a).to(device)
                       for a in SC.search_case(name, w))
            for side in K.SIDES:
                tag = f"keysearch.search {name} W={w} {side}"
                exact_parts(tag, one("keysearch.search", tag,
                                     lambda: K.searchsorted(keys, q,
                                                            side=side)),
                            K.searchsorted_plain(keys, q, side=side))
            sweep_and_probe(f"{name} W={w}", *(
                torch.from_numpy(a).to(device) for a in SC.sweep_case(name,
                                                                       w)))
    for name in PC.PROBE_NAMES:
        for w in (3, 5):
            keys, _, rb, re = (torch.from_numpy(a).to(device)
                               for a in PC.probe_case(name, w))
            live = ~torch.all(rb == K.SENTINEL_WORD, dim=1)
            tag = f"probe case {name} W={w}"
            exact_parts(f"sweep_ranks {tag}", one(
                "sweep_ranks", tag,
                lambda: D.sweep_read_ranks(keys, rb, re, live)),
                D.sweep_read_ranks_plain(keys, rb, re, live))
    for name in SC.COUNT_NAMES:
        c = SC.count_case(name)
        ids = torch.from_numpy(c.ids).to(device)
        tag = f"keysearch.counts {name}"
        exact(tag, one("keysearch.counts", tag,
                       lambda: G._sorted_counts(ids, c.n_seg)),
              G._sorted_counts_plain(ids, c.n_seg))
    log(f"  keysearch.search on {len(SC.SEARCH_NAMES)} search cases at W = "
        f"1 .. 8 (left, right, both), sweep_ranks and keysearch.probe on "
        f"their reads, sweep_ranks on {len(PC.PROBE_NAMES)} probe cases at "
        f"W = 3 and 5, keysearch.counts on {len(SC.COUNT_NAMES)} count "
        "cases: exact, one launch each")


def sweep_bytes(main, rb, re, live) -> int:
    """Kernel E's bytes: the reads' ends and liveness read once, the two
    ranks written once, and the key rows that decide the live reads'
    ends (deciding_rows) read once."""
    r, w = rb.shape
    return (4 * (deciding_rows(main, rb[live], re[live]) * w + 2 * r * w
                 + 2 * r) + r)


def sweep_inputs(gen, ycsb_group, device) -> tuple:
    """Kernel E at the range-scan path's shape: a group of YCSB-E batches'
    reads (rb, re, liveness, flattened: 524,288 at a group of 8) against
    a main tier dense in the YCSB keyspace, 3/4 live, so both ends tie
    with main boundaries often. Returns (main, rb, re, live)."""
    import torch

    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import keys as K

    sk = torch.unique(torch.randint(0, KEYSPACE + 1, (M,), generator=gen,
                                    device=device))[: 3 * M // 4]
    main = K.sentinel_like(M, W, device)
    main[: sk.shape[0]] = int_keys(sk)

    def flat(key):
        a = np.stack([b.device_args()[key] for b in ycsb_group])
        return interop.to_torch(a.reshape(-1, *a.shape[2:]), device)

    rb, re, live = flat("read_begin"), flat("read_end"), flat("read_valid")
    ties = [int((K.searchsorted_plain(main, q, side="left")
                 != K.searchsorted_plain(main, q, side="right"))[live].sum())
            for q in (rb, re)]
    log(f"  sweep_ranks input: {rb.shape[0]} reads ({int(live.sum())} live) "
        f"of a group of {len(ycsb_group)}; {ties[0]} begins and {ties[1]} "
        f"ends equal a main boundary of {sk.shape[0]}")
    return main, rb, re, live


def probe_rows(ledger: dict, long_reads: tuple, point_reads: tuple) -> None:
    """Kernel A's probe timed at its two shapes, each exact against its
    plain version: long reads (the `keysearch.probe` row) and the
    uniform stream's point reads (its `uniform_point_reads` entry); each
    a (hist, table, rb, re). The bound reads the key rows that decide the
    reads' ends (`deciding_rows`, fewer than the tier's real rows at both
    shapes), the reads and the table's two rows a read once, and writes
    the output once."""
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K

    for key, (hist, tab, rb, re) in (
            ("keysearch.probe", long_reads),
            ("keysearch.probe point", point_reads)):
        m, w = hist.main_keys.shape
        q, steps = rb.shape[0], m.bit_length()
        il = K.searchsorted_plain(hist.main_keys, rb, side="right") - 1
        ir = K.searchsorted_plain(hist.main_keys, re, side="left") - 1
        span = (ir - il).clamp(min=0)
        live = real_rows(hist.main_keys)
        rows = deciding_rows(hist.main_keys, rb, re)
        log(f"  {key} input: {q} reads over {m} tier rows ({live:,} real, "
            f"{rows:,} deciding the reads' ends); ir - il: "
            f"{int((span == 0).sum())} at 0, "
            f"{int(((span > 0) & (span < 4)).sum())} in 1..3, "
            f"{int((span >= 4).sum())} at 4 or more (max {int(span.max())})")
        measure(ledger, "keysearch.probe",
                functools.partial(H.query_reads_vmax, hist, rb, re, tab),
                functools.partial(H.query_reads_vmax_plain, hist.main_keys,
                                  tab, rb, re),
                n_bytes=4 * (rows * w + 2 * q * w + 3 * q),
                n_ops=2 * q * steps * w, key=key)
        ledger[key]["real_rows"] = live
        ledger[key]["deciding_rows"] = rows
    ledger["keysearch.probe"]["uniform_point_reads"] = ledger.pop(
        "keysearch.probe point")


def fold_row(ledger: dict, gen, ranks: list, n_map: int) -> None:
    """Kernel H timed at a classic group of 8's shape: the last batch's
    committed writes painted over the map batches 0 .. 6 left (folded at
    ascending versions, as the group loop does), exact against its plain
    version in place; then the same with one write over the whole space,
    and the scratch left zero."""
    import torch

    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H

    device = ranks[0][0].device
    hmap = torch.full((n_map,), H.VERSION_NEG, dtype=torch.int32,
                      device=device)
    for i in range(GROUP - 1):
        cwi = torch.rand((B,), generator=gen, device=device) < 0.97
        G.seg_fold_plain(hmap, ranks[i][2], ranks[i][3], cwi, 3_000_000 + i)
    wb1, we1 = ranks[GROUP - 1][2], ranks[GROUP - 1][3]
    cw1 = torch.rand((B,), generator=gen, device=device) < 0.97
    covered = int(G.seg_fold_plain(torch.zeros_like(hmap), wb1, we1, cw1,
                                   1).sum())
    log(f"  seg_fold input: {B} writes ({int(cw1.sum())} committed) "
        f"covering {covered} of {n_map} ranks, over a map of "
        f"{int(hmap.unique().numel())} distinct versions")
    scratch = G.seg_fold_scratch(n_map, device)
    painted, painted_p = hmap.clone(), hmap.clone()   # the same each call
    measure(ledger, "seg_fold",
            lambda: G.seg_fold(painted, wb1, we1, cw1, 3_200_000, scratch),
            lambda: G.seg_fold_plain(painted_p, wb1, we1, cw1, 3_200_000),
            n_bytes=9 * B + 4 * covered, n_ops=2 * int(cw1.sum()) + covered,
            detail=True)
    wb_all, we_all, cw_all = wb1.clone(), we1.clone(), cw1.clone()
    wb_all[0], we_all[0], cw_all[0] = 0, n_map - 1, True
    exact("seg_fold whole-space write",
          G.seg_fold(hmap.clone(), wb_all, we_all, cw_all, 3_200_000,
                     scratch),
          G.seg_fold_plain(hmap.clone(), wb_all, we_all, cw_all, 3_200_000))
    if scratch is not None:   # the card's kernel; None on the CPU
        exact("seg_fold scratch left zero", scratch,
              torch.zeros_like(scratch))


def probe_fold_edge_checks(device) -> None:
    """Kernels A's probe and H exact against their plain versions on
    every case of testing/probe_cases (the probe at W = 3 and 5: reads at
    and across the fence rows, point reads, reads past the window,
    inverted reads inside and across segments, the tier's ends and
    sentinels, dead rows, empty reads, a full tier, duplicate keys, a
    tier wholly in the fence; the fold: inverted committed writes over
    normal ones, a write over the whole space, rank n, empty and
    uncommitted rows, every width class, the wide list full and at its
    most, the paint budget passed, negative ranks, the bench shape), one
    launch a call, the fold in place with its scratch left zero."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import rangemax
    from foundationdb_tpu_torch.testing import probe_cases as PC

    def one_launch(name, tag, before):
        if kernels.COUNTS[name] - before != 1:
            fail(f"{tag}: {kernels.COUNTS[name] - before} launches, not one")

    for name in PC.PROBE_NAMES:
        for w in (3, 5):
            c = PC.probe_case(name, w)
            keys, ver, rb, re = (torch.from_numpy(x).to(device) for x in c)
            tab = rangemax.build_plain(ver, op="max")
            hist = H.VersionHistory(keys, ver, H.VERSION_NEG,
                                    torch.zeros((), dtype=torch.bool,
                                                device=device))
            before = kernels.COUNTS["keysearch.probe"]
            got = H.query_reads_vmax(hist, rb, re, tab)
            one_launch("keysearch.probe", f"probe {name} W={w}", before)
            exact(f"keysearch.probe {name} W={w}", got,
                  H.query_reads_vmax_plain(keys, tab, rb, re))
    for name in PC.FOLD_NAMES:
        c = PC.fold_case(name)
        seg, wb, we, cw = (torch.from_numpy(x).to(device) for x in c[:4])
        scratch = G.seg_fold_scratch(seg.shape[0], device)
        got = seg.clone()
        before = kernels.COUNTS["seg_fold"]
        if G.seg_fold(got, wb, we, cw, c.version, scratch) is not got:
            fail(f"seg_fold {name}: not in place")
        one_launch("seg_fold", f"seg_fold {name}", before)
        exact(f"seg_fold {name} ({PC.FOLD_PATH[name]})", got,
              G.seg_fold_plain(seg.clone(), wb, we, cw, c.version))
        exact(f"seg_fold {name} scratch left zero", scratch,
              torch.zeros_like(scratch))
    log(f"  keysearch.probe on {len(PC.PROBE_NAMES)} edge cases at W = 3 and "
        f"5, seg_fold on {len(PC.FOLD_NAMES)}: exact, one launch each")


def _launch_bytes(entry: str, a: list) -> int:
    """The bytes one launch of a C entry point must move, from its
    arguments as kernels.launch gets them: its inputs read once and its
    outputs written once, as the phase-2 bounds count them, leaving out
    what depends on the data (the distinct rows
    of a dedup, the key rows that decide a search's or a probe's
    answers), so it is a floor, except for mm_merge: its rows are
    known on the card only, so both maps count whole, sentinel tails too,
    an upper figure for that entry. What depends on the data and is
    counted when launch_totals() is read (the launch's tensors are kept
    until then, so the count syncs no run): ks_query's 4 B a distinct
    table entry a query reads (query_bytes; beside 12 B a query),
    rm2_query's 4 B a row, chunk maximum or table entry its ranges read
    (beside 12 B a query), sf_fold's 4 B a rank its
    writes cover (beside 9 B a write), ss_range's 4 B a value its queries
    read (beside 12 B a query) and ss_apply's 4 B a covered leaf, written
    and read back, the int32 min the function needs (beside 12 B a write
    and 12 B a read; its design moves 8 B a leaf, stamp and min)."""
    if entry == "ks_search":             # keys, m, w, queries, q, side
        w, q = a[2], a[4]                # (2: both indices), out
        return 4 * q * (w + (2 if a[5] == 2 else 1))
    if entry == "ks_counts":             # ids, n, n_seg, off
        return 4 * (a[1] + a[2] + 1)
    if entry == "ks_query":              # table, levels, m, lo, hi, q, ...
        LAUNCH_BYTES["later"].append(
            lambda: query_bytes(a[1], a[2], a[3], a[4]) - 12 * a[5])
        return 12 * a[5]
    if entry == "ks_probe":              # keys, m, w, table, levels, rb,
        w, q = a[2], a[7]                # re, q, out
        return 4 * (2 * q * w + 3 * q)
    if entry == "rm_build":              # values, table, m, levels, ...
        return 4 * a[2] * (1 + a[3])
    if entry == "mc_cover":              # lo, hi, val, n, leaves, table
        return 4 * (3 * a[3] + a[4])
    if entry == "mm_merge":              # a_keys, a_val, na, b_keys,
        return merge_bound(a[2], a[5], a[8], a[6])["n_bytes"]  # nb, w, cap
    if entry == "mm_merge_writes":       # a_keys, a_val, na, b_keys, nb,
        w, na, nb, cap = a[5], a[2], a[4], a[8]  # w, version, floor, cap
        return 4 * ((na + cap) * (w + 1) + nb * w)
    if entry == "rm4_build":             # values, table, m, levels, ...
        return 4 * a[2] * (1 + a[3])
    if entry == "rm4_query":             # table, levels, m, lo, hi, q, ...
        return 7 * 4 * a[5]
    if entry == "mc_cover4":             # lo, hi, val, n, leaves, table
        return 4 * (3 * a[3] + a[4])
    if entry == "sw_ranks":              # keys, m, w, rb, re, rvalid, r
        w, r = a[2], a[6]
        return 4 * (2 * r * w + 2 * r) + r
    if entry == "lo_sort":               # rows, n, w, out_rows, out_perm
        return a[1] * (2 * a[2] * 4 + 4)
    if entry == "sr_heads":              # srt, n, w, sums
        return 4 * a[1] * a[2]
    if entry == "sr_write":              # srt, perm, n, w, sums, ranks,
        return 4 * a[2] * (2 * a[3] + 2)  # ukeys, count
    if entry == "dd_split":              # ukeys, nr, w, u, urb, ure
        return 4 * 4 * a[3] * a[2]
    if entry == "dd_gather":             # vmax_u, rank, n, u, vmax
        return 4 * 2 * a[2]
    if entry == "rm2_build":             # values, m, chunk, nc, table, ns,
        return 4 * (a[1] + a[3] + a[6] * a[5])  # levels, ...
    if entry == "rm2_query":             # values, m, ..., lo, hi, q (8)
        LAUNCH_BYTES["later"].append(
            lambda: 4 * rangemax2_rows(a[6], a[7], a[1]))
        return 12 * a[8]
    if entry == "sf_fold":               # wb, we, cw, nw, n, ...
        LAUNCH_BYTES["later"].append(
            lambda: 4 * covered_ranks(a[0], a[1], a[2], a[4]))
        return 9 * a[3]
    if entry == "ss_range":              # values, n, lo, hi, q, span, ...
        LAUNCH_BYTES["later"].append(
            lambda: 4 * int((a[3] - a[2]).clamp(0, a[5]).sum()))
        return 12 * a[4]
    if entry == "ss_apply":              # wlo, whi, val, nw, qlo, qhi, nr,
        LAUNCH_BYTES["later"].append(    # span, leaves, ...
            lambda: 2 * 4 * covered_leaves(a[8], *a[:3], a[7]))
        return 12 * (a[3] + a[6])
    if entry == "sc_clip":
        return clip_bytes(*(a[i] for i in (2, 3, 8, 9, 13, 14)))
    if entry == "sc_combine":            # ..., s (6), gn, b, nr
        return combine_bytes(*a[6:10])
    return 0


def clip_bytes(s: int, w: int, gn: int, nr: int, nw: int, b: int) -> int:
    """Kernel I's bytes: each range read once (keys, valid byte, a read's
    txn), its S clipped copies and the [S, G, B] has_reads written once."""
    reads, writes = gn * nr, gn * nw
    return (reads * (8 * w + 5) + writes * (8 * w + 1) + 8 * s * w
            + s * ((reads + writes) * (8 * w + 1) + gn * b))


def combine_bytes(s: int, gn: int, b: int, nr: int) -> int:
    """Kernel J's bytes: S shards' verdicts, first indices, hits and flags
    read once, the combined ones and the counts written once."""
    return (s + 1) * gn * (8 * b + nr + 1) + s + gn * b + 1 + 12 * gn


def covered_ranks(wb, we, cw, n: int) -> int:
    """The ranks of [0, n) a fold's committed writes cover."""
    import torch

    from foundationdb_tpu_torch.ops import group as G

    flags = torch.zeros((n,), dtype=torch.int32, device=wb.device)
    return int(G.seg_fold_plain(flags, wb, we, cw, 1).sum())


def covered_leaves(leaves: int, wlo, whi, val, span: int) -> int:
    """The leaves of [0, leaves) a short-span application's committed
    writes cover (kernel K's cover, plain)."""
    from foundationdb_tpu_torch.ops import group as G

    return int((G.ss_cover_plain(leaves, wlo, whi, val, span)
                < G.INT32_POS).sum())


#: the byte floor of every launch since reset_launches(), and a function
#: for each launch whose data-dependent bytes launch_totals() adds
LAUNCH_BYTES = {"total": 0, "later": []}


def count_launch_bytes() -> None:
    """Wrap kernels.launch so each launch also adds its byte floor to
    LAUNCH_BYTES. The wrapper's own count is untouched: the original
    launch still adds one to COUNTS, and only there."""
    from foundationdb_tpu_torch import kernels

    launch = kernels.launch

    def counted(entry, count, *args):
        before = kernels.COUNTS[count]
        launch(entry, count, *args)
        if kernels.COUNTS[count] != before:
            LAUNCH_BYTES["total"] += _launch_bytes(entry, list(args))

    kernels.launch = counted


def reset_launches() -> None:
    from foundationdb_tpu_torch import kernels

    kernels.reset_counts()
    LAUNCH_BYTES["total"] = 0
    LAUNCH_BYTES["later"].clear()


def launch_totals() -> tuple:
    """(launches per kernel, the byte floor of those launches)."""
    from foundationdb_tpu_torch import kernels

    for later in LAUNCH_BYTES["later"]:
        LAUNCH_BYTES["total"] += later()
    LAUNCH_BYTES["later"].clear()
    return kernels.counts(), LAUNCH_BYTES["total"]


def device_bound_per_batch(stream: dict) -> float:
    """The per-batch device bound of a stream's kernels: the byte floor
    of every launch of its main-path run (each launch's own shape) over
    the card's memory rate, per batch. The library sorts and scans
    between the launches are not in it."""
    return (stream["launch_bytes"] / HBM_BYTES_PER_S * 1e3
            / stream["batches"])


def group_points(batches, device):
    """Every endpoint row of a group of batches, batch after batch (rb, re,
    wb, we of each), dead rows the sentinel: the rows the classic group
    kernel ranks, [2G(NR+NW), W]."""
    import torch

    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import keys as K

    rows, lives = [], []
    for pb in batches:
        a = interop.device_args_to_torch(pb.device_args(), device)
        rows.append(torch.cat([a["read_begin"], a["read_end"],
                               a["write_begin"], a["write_end"]]))
        lives.append(torch.cat([a["read_valid"], a["read_valid"],
                                a["write_valid"], a["write_valid"]]))
    return torch.where(torch.cat(lives)[:, None], torch.cat(rows),
                       K.SENTINEL_WORD).contiguous()


def radix_passes(rows) -> int:
    """The 8-bit digits of [P, Wr] rows that take more than one value
    over the rows that are not all ones: kernel N's radix passes."""
    import torch

    live = rows[~torch.all(rows == -1, dim=1)].to(torch.int64) & 0xFFFFFFFF
    return sum(int(torch.unique((live[:, j] >> (8 * b)) & 0xFF).numel() > 1)
               for j in range(rows.shape[1]) for b in range(4))


def group_ranks(batches, device):
    """The group-wide dense ranks of every live endpoint of a group of
    batches, as the classic group kernel computes them: [batch][rb, re,
    wb, we] rank tensors, and the map size 2G(NR+NW)."""
    from foundationdb_tpu_torch.ops import group as G

    gn = len(batches)
    pts = group_points(batches, device)
    grank = G._group_ranks(pts, gn)[0].reshape(gn, -1)
    nr, nw = batches[0].read_begin.shape[0], batches[0].write_begin.shape[0]
    cuts = (0, nr, 2 * nr, 2 * nr + nw, 2 * nr + 2 * nw)
    return ([[grank[i, cuts[j]:cuts[j + 1]].contiguous() for j in range(4)]
             for i in range(gn)], pts.shape[0])


def g_rows(ledger: dict, gen, ranks: list, n_map: int, device) -> None:
    """Kernel G's ledger rows over a classic group of 8's n_map ranks:
    its build (max, and min exact), and its query at batch 1's reads at
    their own ranks (the path's input: the `rangemax2.query` row, with
    the span histogram logged) and at a synthetic mix of those reads
    (every 4th 33-200,000 ranks wide, every 16th empty: its
    `synthetic_mix`), each exact against the plain version at max and
    min and timed. G's values are random int32 versions, all but surely
    distinct per chunk, so a wrong chunk, superchunk or table level shows
    (a map of a few versions could answer right from the wrong entry)."""
    import torch

    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import rangemax

    seg = torch.randint(H.VERSION_NEG, rangemax.INT32_POS, (n_map,),
                        generator=gen, device=device, dtype=torch.int32)
    rrb, rre = ranks[1][0], ranks[1][1]        # batch 1's reads
    qlo, qhi = rrb.clone(), rre.clone()
    nr = qlo.shape[0]
    wide = torch.arange(0, nr, 4, device=device)
    qhi[wide] = (qlo[wide] + torch.randint(
        33, 200_000, (wide.shape[0],), generator=gen, device=device,
        dtype=torch.int32)).clamp(max=n_map)
    empty = torch.arange(1, nr, 16, device=device)
    qhi[empty] = qlo[empty] - torch.randint(0, 3, (empty.shape[0],),
                                            generator=gen, device=device,
                                            dtype=torch.int32)
    for tag, lo, hi in (("stream ranks", rrb, rre),
                        ("synthetic mix", qlo, qhi)):
        span = (hi - lo).clamp(min=0)
        hist = torch.bincount(span.clamp(max=33).to(torch.int64),
                              minlength=34).tolist()
        log(f"  rangemax2 {tag}: {n_map} ranks (a group of {GROUP}), {nr} "
            f"queries: {hist[0]} empty, spans 1..8 {hist[1:9]}, 9..32 "
            f"{sum(hist[9:33])}, wider {hist[33]} (max {int(span.max())})")
    nc = -(-n_map // rangemax.CHUNK)
    ns = -(-n_map // rangemax.SUPER)
    ls = rangemax._num_levels(ns)

    def rm2_check(op):
        def check(name, got, want):
            if len(got) == 2:   # a CPU tensor: build2 is the plain version
                return max(exact(name + " fine", got[0], want[0]),
                           exact(name + " coarse", got[1], want[1]))
            chunk, table = rm2_expected(want, op)
            return max(exact(name + " chunk maxima", got[1], chunk),
                       exact(name + " table", got[2], table))
        return check

    measure(ledger, "rangemax2.build",
            lambda: rangemax.build2(seg, op="max"),
            lambda: rangemax.build2_plain(seg, op="max"),
            n_bytes=4 * (n_map + nc + ls * ns), n_ops=n_map + nc + ls * ns,
            check=rm2_check("max"), detail=True)
    rm2_check("min")("rangemax2.build min", rangemax.build2(seg, op="min"),
                     rangemax.build2_plain(seg, op="min"))
    for op in ("max", "min"):
        tabs = rangemax.build2(seg, op=op)
        plain_tabs = rangemax.build2_plain(seg, op=op)
        for tag, lo, hi in (("stream", rrb, rre), ("synthetic", qlo, qhi)):
            key = ("rangemax2.query" if tag == "stream"
                   else "rangemax2.query synthetic")
            if op == "max":
                rows = rangemax2_rows(lo, hi, n_map)
                measure(ledger, "rangemax2.query",
                        functools.partial(rangemax.query2, tabs, lo, hi,
                                          op=op),
                        functools.partial(rangemax.query2_plain, plain_tabs,
                                          lo, hi, op=op),
                        n_bytes=nr * 12 + rows * 4, n_ops=rows, key=key)
            else:
                exact(f"rangemax2.query min, {tag}",
                      rangemax.query2(tabs, lo, hi, op=op),
                      rangemax.query2_plain(plain_tabs, lo, hi, op=op))
    ledger["rangemax2.query"]["synthetic_mix"] = ledger.pop(
        "rangemax2.query synthetic")


def rangemax2_rows(lo, hi, m: int) -> int:
    """Values, chunk maxima and table entries kernel G's query must read
    for these ranges (the data-dependent part of its byte bound): every
    row of a range with no whole chunk; else the partial head and tail
    chunks' rows, plus every chunk maximum of a range with no whole
    superchunk, else the partial superchunks' chunk maxima and two
    table entries."""
    import torch

    from foundationdb_tpu_torch.ops import rangemax as R

    lo = lo.to(torch.int64).clamp(0, m)
    hi = hi.to(torch.int64).clamp(0, m)
    c0, c1 = (lo + R.CHUNK - 1) // R.CHUNK, hi // R.CHUNK
    s0, s1 = (c0 + R.CHUNK - 1) // R.CHUNK, c1 // R.CHUNK
    chunks = torch.where(s0 < s1, (s0 * R.CHUNK - c0) + (c1 - s1 * R.CHUNK)
                         + 2, c1 - c0)
    split = (c0 * R.CHUNK - lo) + (hi - c1 * R.CHUNK) + chunks
    rows = torch.where(c0 < c1, split, hi - lo)
    return int(torch.where(hi > lo, rows, 0).sum())


def rm2_expected(plain, op: str):
    """What kernel G builds, from the plain (JAX-layout) structure: the
    chunk maxima (the top fine level every CHUNK rows) and kernel B's
    plain table over the op of each superchunk's CHUNK chunk maxima."""
    import torch

    from foundationdb_tpu_torch.ops import rangemax as R

    chunk = plain[0][R.CHUNK_BITS][::R.CHUNK].contiguous()
    ns = -(-chunk.shape[0] // R.CHUNK)
    pad = torch.full((ns * R.CHUNK,), R.INT32_POS if op == "min"
                     else R.INT32_NEG, dtype=torch.int32, device=chunk.device)
    pad[:chunk.shape[0]] = chunk
    sup = pad.reshape(ns, R.CHUNK)
    sup = sup.amin(dim=1) if op == "min" else sup.amax(dim=1)
    return chunk, R.build_plain(sup.contiguous(), op=op)


def phase_torch_ops(device) -> dict:
    """K10 (the version rebase of both tiers) and K21 (the live-boundary
    counts of both tiers, and of 4 shards' tiers): plain torch ops in the
    port, timed at the tiers' size beside their byte bound."""
    import torch

    from foundationdb_tpu_torch.models.conflict_set import _rebase_tiered
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.ops import history as H

    gen = torch.Generator(device=device)
    gen.manual_seed(7)

    def tier(n_live):
        keys, _ = random_sorted_keys(gen, n_live, M, device)
        ver = torch.randint(0, 1 << 30, (M,), generator=gen, device=device,
                            dtype=torch.int32)
        ver[n_live:] = H.VERSION_NEG
        return H.VersionHistory(keys, ver, 5, torch.zeros(
            (), dtype=torch.bool, device=device))

    state = D.TieredState(main=tier(M // 2), delta=tier(M // 2))
    shards = (state,) + tuple(D.TieredState(main=tier(M // 2),
                                            delta=tier(M // 4))
                              for _ in range(SHARDS - 1))
    rows = {}
    for name, fn, n_bytes, what in (
            ("K10 _rebase_tiered", lambda: _rebase_tiered(state, 1 << 29),
             2 * M * 4 * 2, "both tiers"),
            ("K21 boundary_counts", lambda: D.boundary_counts(state),
             2 * M * W * 4 + 2 * 8, "both tiers"),
            ("K21 boundary_counts_per_shard",
             lambda: D.boundary_counts_per_shard(shards),
             SHARDS * (2 * M * W * 4 + 2 * 8), f"{SHARDS} shards' tiers")):
        t = device_ms(fn)
        b, by = bound_ms(n_bytes, 0)
        rows[name] = dict(ms=t, bound_ms=b, bound_by=by)
        log(f"  {name:29s} device {t * 1e3:9.1f} us  bound {b * 1e3:7.1f} "
            f"us ({by}), {what} of {M} rows")
    return rows


# ---------------------------------------------------------------------------
# the main paths

def bench_config(n: int, **kw):
    from foundationdb_tpu_torch.config import KernelConfig

    return KernelConfig(**{
        "max_key_bytes": KEY_BYTES, "max_txns": n, "max_reads": n,
        "max_writes": n, "history_capacity": 12 * n,
        "delta_capacity": 12 * n, "window_versions": WINDOW,
        "fixpoint_unroll": 3, "compact_interval": COMPACT_INTERVAL, **kw,
    })


def zipf_stream(cfg, n: int, seed: int = 0, start: int = 0) -> list:
    """bench `zipf`: one point read and one point write per txn, zipf 1.1
    over 10M keys."""
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch

    rng = np.random.default_rng(seed)
    return [skiplist_style_batch(rng, cfg, B,
                                 version=(start + i + 1) * VERSION_STEP,
                                 keyspace=ZIPF_KEYSPACE, zipf=ZIPF,
                                 snapshot_lag=SNAPSHOT_LAG,
                                 key_bytes=KEY_BYTES) for i in range(n)]


def ycsb_stream(cfg, n: int, seed: int = 0, start: int = 0) -> list:
    """bench `ycsb_e`: 95% of txns scan up to 100 keys from a zipf 1.1
    start, every txn inserts one fresh key, keyspace 1M."""
    from foundationdb_tpu_torch.testing.benchgen import ycsb_batch

    rng = np.random.default_rng(seed)
    frontier, out = KEYSPACE // 2, []
    for i in range(n):
        b = ycsb_batch(rng, cfg, B, "ycsb_e",
                       version=(start + i + 1) * VERSION_STEP,
                       keyspace=KEYSPACE, zipf=ZIPF, scan_max=100,
                       snapshot_lag=SNAPSHOT_LAG, key_bytes=KEY_BYTES,
                       insert_frontier=frontier)
        frontier += b.n_writes
        out.append(b)
    return out


def dedup_size(batches) -> tuple:
    """bench's dedup cap: the stream's most distinct (begin, end) read
    rows in one batch, to the next power of two (dedup stays off past
    half the batch, and then this path would not run: fail)."""
    max_uniq = max(
        len(np.unique(np.concatenate([b.read_begin[: b.n_reads],
                                      b.read_end[: b.n_reads]], axis=1),
                      axis=0)) for b in batches)
    if max_uniq > B // 2:
        fail(f"zipf stream has {max_uniq} distinct reads per batch; bench "
             "would not arm read dedup")
    return 1 << (max_uniq - 1).bit_length(), max_uniq


def quartiles() -> list:
    """The sharded stream's partition: the keyspace quartiles as 8-byte
    big-endian keys (the bench keys are such integers below 2^20, so the
    first-byte default_boundaries would put every key on shard 0)."""
    return [(i * KEYSPACE // SHARDS).to_bytes(KEY_BYTES, "big")
            for i in range(1, SHARDS)]


def groups_of(batches) -> list:
    from foundationdb_tpu_torch.utils.packing import stack_device_args

    return [stack_device_args(batches[i:i + GROUP])
            for i in range(0, len(batches), GROUP)]


def verdict_fields(out) -> dict:
    return {f: getattr(out, f).cpu() for f in out._fields}


def same_fields(tag: str, got: dict, want: dict) -> None:
    import torch

    for f, v in want.items():
        if not torch.equal(got[f], v):
            fail(f"{tag}: field {f} differs")


def same_state(tag: str, got, want) -> None:
    """Both tiers (tiered), or the single tier (classic), row for row."""
    if not isinstance(got[0], tuple):
        got, want, names = (got,), (want,), ("tier",)
    else:
        names = ("main", "delta")
    for tier, g, w in zip(names, got, want):
        for part, a, b in zip(("keys", "ver", "oldest", "overflow"), g, w):
            if not np.array_equal(a, b):
                fail(f"{tag}: {tier} {part} differs")


def state_of(cs):
    """The conflict set's history as numpy (either path)."""
    return cs.store_state()[0]


#: the kernels only the classic group kernel at G > 1 launches
CLASSIC_ONLY = ("rangemax2.build", "rangemax2.query", "seg_fold")
#: the kernels only the sharded path launches
SHARDED_ONLY = ("shard_clip", "shard_combine")
#: the kernels only the short-span variant launches
SHORT_SPAN_ONLY = ("short_span.range", "short_span.apply")
#: the kernel only the short-span group kernel's cross span at G > 1
#: launches (ops/group._block_spans: a both-sides and a left search)
CROSS_SPAN_ONLY = ("keysearch.search",)
#: the kernels no resolver path launches: the reference's scripts alone
#: reach K16 and K19, so their path launches are 0 (phase 2's one call
#: each is in launches_per_call)
OFF_PATH = ("merge_writes", "rangemax4.build", "rangemax4.query",
            "rangemax4.cover")


def one_fold_a_batch(tag: str, launches: dict, n_batches: int) -> None:
    """Kernel H is one launch a call, and the group kernel folds each
    batch once: its launches must equal the batches."""
    if launches["seg_fold"] != n_batches:
        fail(f"seg_fold: {launches['seg_fold']} launches over the {tag} "
             f"path's {n_batches} batches, not one a batch")


def require_launched(tag: str, launches: dict, unused=()) -> None:
    for name, n in launches.items():
        if name not in unused and n <= 0:
            fail(f"{name}: not launched on the {tag} path")


def run_groups(cs, groups) -> tuple:
    """Each stacked group through resolve_group_args, synchronised:
    (seconds per group, verdict fields per group, the history after the
    first group)."""
    import torch

    times, outs, first = [], [], None
    for i, g in enumerate(groups):
        t0 = time.perf_counter()
        out = cs.resolve_group_args(g)
        if cs.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(verdict_fields(out))
        if i == 0:
            first = state_of(cs)
    return times, outs, first


def watch_occupancy(cs) -> list:
    """(main, delta) live rows just before each compaction of `cs` (one
    sync each): the peak delta occupancy of an untimed run."""
    from foundationdb_tpu_torch.ops import delta as D

    peaks, compact = [], cs.compact_history

    def sampled():
        peaks.append([int(c) for c in D.boundary_counts(cs.state)])
        compact()

    cs.compact_history = sampled
    return peaks


def uniform_stream(cfg, n: int, seed: int = 0, start: int = 0) -> list:
    """bench's default stream: one point read and one point write per
    txn, uniform over 1M keys."""
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch

    rng = np.random.default_rng(seed)
    return [skiplist_style_batch(rng, cfg, B,
                                 version=(start + i + 1) * VERSION_STEP,
                                 keyspace=KEYSPACE, snapshot_lag=SNAPSHOT_LAG,
                                 key_bytes=KEY_BYTES) for i in range(n)]


def phase_stream(device, batches) -> dict:
    """The full-width uniform stream; returns what the ledger needs, and
    every batch's verdict fields under "outs"."""
    import torch

    from foundationdb_tpu_torch import interop, kernels, make_conflict_set
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.ops import rangemax

    cfg = bench_config(B)
    key = (str(device), cfg.history_capacity)
    if key in rangemax._SELFTEST_OK:
        fail("the rangemax self-check ran before the first conflict set")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = make_conflict_set(cfg, "cuda")
    torch.cuda.synchronize()
    ctor_ms = (time.perf_counter() - t0) * 1e3
    if key not in rangemax._SELFTEST_OK:
        fail("the constructor did not run the rangemax self-check")
    t0 = time.perf_counter()
    rangemax.flat_gather_selftest(cfg.history_capacity, device=device,
                                  force=True)
    selftest_ms = (time.perf_counter() - t0) * 1e3
    m = cfg.history_capacity
    selftest_bound, _ = bound_ms(
        (1 + rangemax._num_levels(m)) * m * 4 + 8192 * 12, 0)
    log(f"  K20 self-check at m={m}, 8,192 queries: ran in the constructor "
        f"({ctor_ms:.1f} ms with the state's allocation); alone "
        f"{selftest_ms:.1f} ms; its device bound {selftest_bound * 1e3:.1f}"
        " us (bytes: the values, the table and the queries once)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    n_cmp = COMPACT_INTERVAL + 1
    per_batch, gpu_outs, occupancy = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        out = cs.resolve_packed(b)
        torch.cuda.synchronize()
        per_batch.append(time.perf_counter() - t0)
        gpu_outs.append(verdict_fields(out))
        occupancy.append([int(c) for c in D.boundary_counts(cs.state)])
        if i == N_CPU_CHECK - 1:
            gpu_state = interop.tiered_state_to_numpy(cs.state)
    launches, launch_bytes = launch_totals()
    peak = torch.cuda.max_memory_allocated(device)
    final = state_of(cs)
    cs.check_overflow()
    require_launched("uniform", launches,
                     ("sweep_ranks", "read_dedup", *CLASSIC_ONLY,
                      *SHARDED_ONLY, *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY,
                      *OFF_PATH))
    log(f"  {N_BATCHES} batches x {B} txns; launches on the main path: "
        f"{launches}")

    # the CPU plain path on the first N_CPU_CHECK batches
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t0 = time.perf_counter()
    for i, b in enumerate(batches[:N_CPU_CHECK]):
        same_fields(f"uniform batch {i} vs the CPU plain path", gpu_outs[i],
                    verdict_fields(cpu.resolve_packed(b)))
    cpu_s = time.perf_counter() - t0
    same_state(f"uniform, after batch {N_CPU_CHECK - 1}, vs the CPU plain "
               "path", gpu_state, interop.tiered_state_to_numpy(cpu.state))
    log(f"  first {N_CPU_CHECK} batches identical to the CPU plain path, "
        f"field by field, and both tiers identical row for row after them "
        f"({cpu_s:.1f} s on the CPU)")

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
    log(f"  compactions {cs.metrics.counters.get('compactions')}")
    extra = uniform_stream(cfg, 2, seed=1, start=N_BATCHES)

    def run():
        for b in extra:
            cs.resolve_packed(b)

    # K21 runs on each overflow check, K10 on each rebase
    checks, rebases = (cs.metrics.main_occupancy.count,
                       cs.metrics.counters.get("rebases"))
    prof = profile_run(run, ms, len(extra))
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=N_BATCHES, ms_per_batch=ms,
                txn_per_s=B / ms * 1e3, selftest_ms=selftest_ms,
                selftest_bound_ms=selftest_bound,
                ctor_ms=ctor_ms, overflow_checks=checks, rebases=rebases,
                outs=gpu_outs, final=final, **prof)


def profile_run(run, wall_ms: float, n_batches: int) -> dict:
    """Device time by kernel over run() (torch.profiler): the device's
    busy and idle share against the unprofiled wall time per batch, and
    the share of the library sorts and scans (the port's own kernels, N's
    radix sort among them, left out)."""
    by_name = profiled(run)
    total = sum(by_name.values()) / 1e3 / n_batches   # ms per batch
    ours = port_kernel_names()

    def library(name: str) -> bool:
        m = PORT_KERNEL.match(name)
        return (not (m and m.group(1) in ours)
                and any(s in name.lower() for s in ("sort", "radix", "scan")))

    lib = sum(t for k, t in by_name.items() if library(k))
    lib_ms = lib / 1e3 / n_batches
    htod = {k: t / 1e3 / n_batches for k, t in by_name.items()
            if k.startswith("Memcpy HtoD")}
    log(f"  profiler over {n_batches} more batches: device busy "
        f"{total:.3f} ms/batch of {wall_ms:.3f} ms wall (idle share "
        f"{1 - total / wall_ms:.3f}); library sort/scan {lib_ms:.3f} "
        f"ms/batch = {lib_ms / total:.3f} of device time; host-to-device "
        f"copies (ms/batch) {htod}")
    for k, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {t / 1e3 / n_batches:9.3f} ms/batch  {k[:100]}")
    return {"device_ms_per_batch": total, "idle_share": 1 - total / wall_ms,
            "sort_scan_ms_per_batch": lib_ms,
            "sort_scan_share_of_device": lib_ms / total,
            "htod_ms_per_batch": htod}


def group_timing(tag: str, times: list) -> float:
    """Steady-state ms/batch: the median over the groups after the first
    (each group synchronised, its wall time over its batches)."""
    per = [t / GROUP * 1e3 for t in times]
    ms = statistics.median(per[1:])
    log(f"  {tag}: {ms:.3f} ms/batch steady state (groups 1..), "
        f"{B / (ms / 1e3):,.0f} txn/s; per group {[round(x, 3) for x in per]}"
        " ms/batch")
    return ms


def phase_hot_key(device, batches, dedup_u: int, max_uniq: int) -> dict:
    """bench `zipf` through the latched + dedup config, in groups of 8."""
    import torch

    from foundationdb_tpu_torch import interop, kernels, make_conflict_set

    cfg = bench_config(B, fixpoint_unroll=ZIPF_UNROLL, fixpoint_latch=True,
                       dedup_reads=dedup_u)
    groups = groups_of(batches)
    cs = make_conflict_set(cfg, "cuda")
    cs.prewarm_exact(groups[0])
    torch.cuda.synchronize()
    reset_launches()
    times, outs, first = run_groups(cs, groups)
    launches, launch_bytes = launch_totals()
    require_launched("hot-key", launches,
                     ("sweep_ranks", *CLASSIC_ONLY, *SHARDED_ONLY,
                      *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH))
    counters = cs.metrics.counters.as_dict()
    log(f"  {len(batches)} batches x {B} txns in groups of {GROUP}; "
        f"U = {dedup_u} (max distinct reads/batch {max_uniq}); launches: "
        f"{launches}")
    log(f"  counters {counters}")
    ms = group_timing("latched + dedup", times)

    # the exact configuration on the card: every field, and the state
    # (unroll 1: the host loop then runs to the real fixpoint depth)
    ex = make_conflict_set(cfg.scaled(fixpoint_latch=False, dedup_reads=0,
                                      fixpoint_unroll=1), "cuda")
    peaks = watch_occupancy(ex)
    ex_times, ex_outs, _ = run_groups(ex, groups)
    for i, (g, w) in enumerate(zip(outs, ex_outs)):
        same_fields(f"hot-key group {i} vs the exact config", g, w)
    same_state("hot-key stream vs the exact config",
               interop.tiered_state_to_numpy(cs.state),
               interop.tiered_state_to_numpy(ex.state))
    fx, efx = cs.metrics.fixpoint, ex.metrics.fixpoint
    log(f"  every group identical to the exact config on the card (its "
        f"groups: {[round(t / GROUP * 1e3, 3) for t in ex_times]} ms/batch"
        f"); fixpoint depth on the exact config (unroll 1, so the host loop "
        f"finds it): max {efx.max_applications} applications/batch, "
        f"{efx.applications} over {efx.batches} batches; latched: "
        f"{fx.applications} applications over {fx.batches} batches")
    log(f"  (main, delta) live rows before each compaction: {peaks}")

    # the CPU plain path on the first group
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t0 = time.perf_counter()
    same_fields("hot-key group 0 vs the CPU plain path", outs[0],
                verdict_fields(cpu.resolve_group_args(groups[0])))
    same_state("hot-key group 0 vs the CPU plain path", first,
               interop.tiered_state_to_numpy(cpu.state))
    log(f"  group 0 identical to the CPU plain path, fields and tiers "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")

    # a dedup cap under the distinct count: every group trips
    tr = make_conflict_set(cfg.scaled(dedup_reads=TRIP_U), "cuda")
    _, tr_outs, tr_first = run_groups(tr, groups[:1])
    tc = tr.metrics.counters.as_dict()
    if not tc["latchTrips"] == tc["exactFallbacks"] > 0:
        fail(f"U={TRIP_U}: expected every group to trip, counters {tc}")
    same_fields(f"U={TRIP_U} group 0 vs the latched run", tr_outs[0],
                outs[0])
    same_state(f"U={TRIP_U} group 0 vs the latched run", tr_first, first)
    log(f"  U = {TRIP_U}: latchTrips {tc['latchTrips']} == exactFallbacks "
        f"{tc['exactFallbacks']}, results identical")

    extra = groups_of(zipf_stream(cfg, GROUP, seed=1, start=len(batches)))
    prof = profile_run(lambda: cs.resolve_group_args(extra[0]), ms, GROUP)
    committed = [int(x) for o in outs for x in o["committed_count"]]
    log(f"  committed/batch {committed}")
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(batches), ms_per_batch=ms,
                txn_per_s=B / ms * 1e3, dedup_reads=dedup_u,
                max_distinct_reads=max_uniq,
                latch_trips=counters["latchTrips"],
                exact_fallbacks=counters["exactFallbacks"],
                exact_max_applications=efx.max_applications,
                peak_delta_rows=max(p[1] for p in peaks),
                trip_run={"dedup_reads": TRIP_U,
                          "latch_trips": tc["latchTrips"],
                          "exact_fallbacks": tc["exactFallbacks"]},
                **prof)


def phase_range_scan(device, batches) -> dict:
    """bench `ycsb_e` through the sweep + spill + latch config, groups
    of 8."""
    import torch

    from foundationdb_tpu_torch import interop, kernels, make_conflict_set
    from foundationdb_tpu_torch.models.conflict_set import (
        backend_for_profile,
        profile_batch,
    )
    from foundationdb_tpu_torch.ops import delta as D

    cfg = bench_config(B, fixpoint_unroll=YCSB_UNROLL, fixpoint_latch=True,
                       range_sweep=True, delta_spill=True)
    prof_name = profile_batch(batches[0])
    routed = backend_for_profile(prof_name, cfg)
    if (prof_name, routed) != ("range_heavy", "cuda"):
        fail(f"ycsb_e classified {prof_name} -> {routed}")
    log(f"  contention profile {prof_name} -> routed {routed}")
    groups = groups_of(batches)
    cs = make_conflict_set(cfg, "cuda")
    cs.prewarm_exact(groups[0])
    torch.cuda.synchronize()
    reset_launches()
    times, outs, first = run_groups(cs, groups)
    launches, launch_bytes = launch_totals()
    require_launched("range-scan", launches,
                     ("read_dedup", *CLASSIC_ONLY, *SHARDED_ONLY,
                      *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH))
    counters = cs.metrics.counters.as_dict()
    log(f"  {len(batches)} batches x {B} txns in groups of {GROUP}; "
        f"launches: {launches}")
    log(f"  counters {counters}; sweep rows per group "
        f"{D.sweep_rows_per_group(cfg.history_capacity, GROUP, B)}")
    ms = group_timing("sweep + spill + latch", times)

    # the probe path on the card: every group, and the state
    probe = make_conflict_set(cfg.scaled(range_sweep=False), "cuda")
    peaks = watch_occupancy(probe)
    probe_times, probe_outs, _ = run_groups(probe, groups)
    for i, (g, w) in enumerate(zip(outs, probe_outs)):
        same_fields(f"range-scan group {i} vs the probe path", g, w)
    same_state("range-scan stream vs the probe path",
               interop.tiered_state_to_numpy(cs.state),
               interop.tiered_state_to_numpy(probe.state))
    log(f"  every group identical to the probe path on the card (its "
        f"groups: {[round(t / GROUP * 1e3, 3) for t in probe_times]} "
        "ms/batch)")
    log(f"  (main, delta) live rows before each compaction: {peaks} of "
        f"({cfg.history_capacity}, {cfg.delta_capacity})")

    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t0 = time.perf_counter()
    same_fields("range-scan group 0 vs the CPU plain path", outs[0],
                verdict_fields(cpu.resolve_group_args(groups[0])))
    same_state("range-scan group 0 vs the CPU plain path", first,
               interop.tiered_state_to_numpy(cpu.state))
    log(f"  group 0 identical to the CPU plain path, fields and tiers "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")

    extra = groups_of(ycsb_stream(cfg, GROUP, seed=1, start=len(batches)))
    prof = profile_run(lambda: cs.resolve_group_args(extra[0]), ms, GROUP)
    committed = [int(x) for o in outs for x in o["committed_count"]]
    log(f"  committed/batch {committed}")
    fx = cs.metrics.fixpoint
    log(f"  fixpoint: {fx.applications} applications over {fx.batches} "
        "batches (latched)")
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(batches), ms_per_batch=ms,
                txn_per_s=B / ms * 1e3, spills=counters["spills"],
                sweep_groups=counters["sweepGroups"],
                compactions=counters["compactions"],
                latch_trips=counters["latchTrips"],
                exact_fallbacks=counters["exactFallbacks"],
                peak_delta_rows=max(p[1] for p in peaks), **prof)


def phase_classic(device, batches, tiered_outs: list) -> dict:
    """bench `BENCH_KERNEL=classic` on the uniform batches: groups of 8
    through the classic group kernel, held to the same batches one at a
    time, to the tiered stream and (group 0) to the CPU plain path."""
    import torch

    from foundationdb_tpu_torch import kernels, make_conflict_set
    from foundationdb_tpu_torch.ops import history as H

    cfg = bench_config(B, delta_capacity=0)
    groups = groups_of(batches)
    cs = make_conflict_set(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    times, outs, maps, occupancy = [], [], [], []
    for g in groups:
        t0 = time.perf_counter()
        out = cs.resolve_group_args(g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(verdict_fields(out))
        maps.append(state_of(cs))
        occupancy.append(int(H.boundary_count(cs.state)))
    launches, launch_bytes = launch_totals()
    peak = torch.cuda.max_memory_allocated(device)
    cs.check_overflow()
    require_launched("classic uniform", launches,
                     ("sweep_ranks", "read_dedup", *SHARDED_ONLY,
                      *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH))
    one_fold_a_batch("classic uniform", launches, len(batches))
    log(f"  {len(batches)} batches x {B} txns in groups of {GROUP} "
        f"(history {cfg.history_capacity}, no delta tier); launches: "
        f"{launches}")
    ms = group_timing("classic G=8", times)

    # (a) the same batches one at a time (resolve_batch, K15) on the card
    one = make_conflict_set(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    per_batch = []
    for i, pb in enumerate(batches):
        t0 = time.perf_counter()
        got = verdict_fields(one.resolve_packed(pb))
        torch.cuda.synchronize()
        per_batch.append(time.perf_counter() - t0)
        gi, j = divmod(i, GROUP)
        same_fields(f"classic batch {i} G=8 vs G=1", got,
                    {f: v[j] for f, v in outs[gi].items()
                     if f != "unconverged"})
        if j == GROUP - 1:
            same_state(f"classic group {gi}: G=8 vs G=1", maps[gi],
                       state_of(one))
    g1_launches, g1_bytes = launch_totals()
    ms1 = statistics.median(per_batch[GROUP:]) * 1e3
    log(f"  every batch identical to G=1 (resolve_batch) on the card, the "
        f"tier identical row for row after every group; G=1 {ms1:.3f} "
        f"ms/batch steady state (batches {GROUP}..), "
        f"{B / (ms1 / 1e3):,.0f} txn/s; launches {g1_launches}")
    # (b) the tiered uniform stream of phase 3 (both exact)
    for i, want in enumerate(tiered_outs):
        gi, j = divmod(i, GROUP)
        same_fields(f"classic batch {i} vs the tiered stream",
                    {f: v[j] for f, v in outs[gi].items()}, want)
    log(f"  all {len(batches)} batches identical to the tiered uniform "
        "stream, field by field")
    # (c) group 0 on the CPU plain path
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t0 = time.perf_counter()
    same_fields("classic group 0 vs the CPU plain path", outs[0],
                verdict_fields(cpu.resolve_group_args(groups[0])))
    same_state("classic group 0 vs the CPU plain path", maps[0],
               state_of(cpu))
    log(f"  group 0 identical to the CPU plain path, fields and tier "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")
    log(f"  live rows of the tier after each group {occupancy} of "
        f"{cfg.history_capacity}; peak device memory {peak / 2**20:.1f} MiB")
    fx = cs.metrics.fixpoint
    log(f"  fixpoint: {fx.applications} applications over {fx.batches} "
        f"batches (max {fx.max_applications}/batch)")
    extra = uniform_stream(cfg, GROUP + 1, seed=1, start=len(batches))
    prof = profile_run(lambda: cs.resolve_group_args(groups_of(
        extra[:GROUP])[0]), ms, GROUP)
    log("  G=1 (resolve_batch), one more batch:")
    prof1 = profile_run(lambda: one.resolve_packed(extra[GROUP]), ms1, 1)
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(batches), ms_per_batch=ms, outs=outs, maps=maps,
                txn_per_s=B / ms * 1e3, g1_ms_per_batch=ms1,
                g1_txn_per_s=B / ms1 * 1e3, peak_rows=max(occupancy),
                peak_device_mib=peak / 2**20,
                g1={"launches_per_batch": {
                        k: n / len(batches) for k, n in g1_launches.items()},
                    "kernel_bound_ms_per_batch": g1_bytes / HBM_BYTES_PER_S
                    * 1e3 / len(batches), **prof1},
                **prof)


def phase_classic_hot(device, batches) -> dict:
    """bench `BENCH_KERNEL=classic BENCH_MODE=zipf`: the latch at unroll
    8 on the classic group kernel, groups of 8, against the exact classic
    config; then a forced-trip run at unroll 1."""
    import torch

    from foundationdb_tpu_torch import kernels, make_conflict_set

    cfg = bench_config(B, delta_capacity=0, fixpoint_unroll=ZIPF_UNROLL,
                       fixpoint_latch=True)
    groups = groups_of(batches)
    cs = make_conflict_set(cfg, "cuda")
    cs.prewarm_exact(groups[0])
    torch.cuda.synchronize()
    reset_launches()
    times, outs, _ = run_groups(cs, groups)
    launches, launch_bytes = launch_totals()
    require_launched("classic hot-key", launches,
                     ("sweep_ranks", "read_dedup", *SHARDED_ONLY,
                      *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH))
    counters = cs.metrics.counters.as_dict()
    log(f"  {len(batches)} batches x {B} txns in groups of {GROUP}; "
        f"counters {counters}; launches: {launches}")
    ms = statistics.mean(t / GROUP * 1e3 for t in times)
    log(f"  latched: {ms:.3f} ms/batch (mean over the {len(groups)} groups: "
        f"{[round(t / GROUP * 1e3, 3) for t in times]})")
    ex = make_conflict_set(cfg.scaled(fixpoint_latch=False, fixpoint_unroll=1),
                           "cuda")
    ex_times, ex_outs, _ = run_groups(ex, groups)
    for i, (g, w) in enumerate(zip(outs, ex_outs)):
        same_fields(f"classic hot-key group {i} vs the exact config", g, w)
    same_state("classic hot-key stream vs the exact config", state_of(cs),
               state_of(ex))
    efx = ex.metrics.fixpoint
    log(f"  every group identical to the exact classic config on the card "
        f"(its groups: {[round(t / GROUP * 1e3, 3) for t in ex_times]} "
        f"ms/batch; depth max {efx.max_applications} applications/batch)")
    tr = make_conflict_set(cfg.scaled(fixpoint_unroll=1), "cuda")
    tr_times, tr_outs, _ = run_groups(tr, groups)
    tc = tr.metrics.counters.as_dict()
    if not tc["latchTrips"] == tc["exactFallbacks"] >= 1:
        fail(f"classic forced trip: expected a fallback, counters {tc}")
    for i, (g, w) in enumerate(zip(tr_outs, ex_outs)):
        same_fields(f"classic forced-trip group {i} vs the exact config",
                    g, w)
    same_state("classic forced-trip stream vs the exact config",
               state_of(tr), state_of(ex))
    log(f"  unroll 1 (forced trip): latchTrips {tc['latchTrips']} == "
        f"exactFallbacks {tc['exactFallbacks']}, results identical "
        f"({[round(t / GROUP * 1e3, 3) for t in tr_times]} ms/batch)")
    extra = groups_of(zipf_stream(cfg, GROUP, seed=1, start=len(batches)))
    prof = profile_run(lambda: cs.resolve_group_args(extra[0]), ms, GROUP)
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(batches), ms_per_batch=ms,
                txn_per_s=B / ms * 1e3,
                latch_trips=counters["latchTrips"],
                exact_ms_per_batch=statistics.mean(
                    t / GROUP * 1e3 for t in ex_times),
                exact_max_applications=efx.max_applications,
                trip_run={"fixpoint_unroll": 1,
                          "latch_trips": tc["latchTrips"],
                          "exact_fallbacks": tc["exactFallbacks"]},
                **prof)


def role_stream(seed: int = 11, n: int = ROLE_BATCHES) -> list:
    """Seeded CommitTransaction batches at the wire Resolver role's
    shape: 1,024 txns of 1-3 reads (a point or a short scan) and 1-2
    point writes over 15-byte keys with a common prefix (a point write's
    end key, the key and a zero byte, fills the 16 bytes exactly)."""
    from foundationdb_tpu_torch.models.types import CommitTransaction

    rng = np.random.default_rng(seed)

    def key(i):
        return b"\x02tbl/" + int(i).to_bytes(10, "big")

    out = []
    for b in range(n):
        version = ROLE_WINDOW // 2 + (b + 1) * ROLE_VERSION_STEP
        txns = []
        for t in range(ROLE_TXNS):
            reads = []
            for _ in range(int(rng.integers(1, 4))):
                k = int(rng.integers(0, ROLE_KEYSPACE))
                reads.append((key(k), key(k + int(rng.integers(1, 12)))))
            writes = [(key(k), key(k) + b"\x00") for k in
                      rng.integers(0, ROLE_KEYSPACE, int(rng.integers(1, 3)))]
            txns.append(CommitTransaction(
                read_conflict_ranges=reads, write_conflict_ranges=writes,
                read_snapshot=version - int(rng.integers(1, 4)
                                            * ROLE_VERSION_STEP),
                report_conflicting_keys=bool(t % 3 == 0)))
        out.append((txns, version))
    return out


def phase_resolver_role(device) -> dict:
    """The wire ResolverRole's default conflict set on the card, through
    resolve() (pack, K15, reply assembly), against the oracle."""
    import torch

    from foundationdb_tpu_torch import kernels, make_conflict_set
    from foundationdb_tpu_torch.config import KernelConfig
    from foundationdb_tpu_torch.ops import history as H

    cfg = KernelConfig(max_key_bytes=ROLE_KEY_BYTES, max_txns=ROLE_TXNS,
                       max_reads=ROLE_RANGES, max_writes=ROLE_RANGES,
                       history_capacity=ROLE_HISTORY,
                       window_versions=ROLE_WINDOW)
    *stream, (extra, extra_version) = role_stream(n=ROLE_BATCHES + 1)
    cs = make_conflict_set(cfg, "cuda")
    oracle = make_conflict_set(cfg, "cpu")
    torch.cuda.synchronize()
    reset_launches()
    times, n_conflict, occupancy, results = [], 0, [], []
    for i, (txns, version) in enumerate(stream):
        t0 = time.perf_counter()
        got = cs.resolve(txns, version)
        times.append(time.perf_counter() - t0)
        occupancy.append(int(H.boundary_count(cs.state)))
        want = oracle.resolve(txns, version)
        if got.verdicts != want.verdicts:
            fail(f"resolver-role batch {i}: verdicts differ from the oracle")
        if got.conflicting_key_ranges != want.conflicting_key_ranges:
            fail(f"resolver-role batch {i}: conflicting key ranges differ")
        results.append((want.verdicts, want.conflicting_key_ranges))
        n_conflict += sum(int(v) == 0 for v in got.verdicts)
    launches, launch_bytes = launch_totals()
    cs.check_overflow()
    if n_conflict == 0:
        fail("resolver-role stream produced no conflicts; it checks nothing")
    steady = sorted(times[1:])
    p50 = statistics.median(steady) * 1e3
    p99 = steady[min(len(steady) - 1, int(0.99 * len(steady)))] * 1e3
    log(f"  {len(stream)} batches x {ROLE_TXNS} txns (W = "
        f"{cfg.key_words}, history {cfg.history_capacity}, window "
        f"{ROLE_WINDOW}) identical to ConflictOracle, reports included "
        f"({n_conflict} conflicts); resolve() p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms per batch (batches 1..); tier peak "
        f"{max(occupancy)} live rows of {ROLE_HISTORY}; launches {launches}")
    prof = profile_run(lambda: cs.resolve(extra, extra_version), p50, 1)
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(stream), p50_ms=p50,
                p99_ms=p99, conflicts=n_conflict, peak_rows=max(occupancy),
                results=results, **prof)


# ---------------------------------------------------------------------------
# phase 12: the staging pipeline


def args_bytes(args: dict) -> int:
    """The bytes one call of interop.device_args_to_torch copies to the
    card: its numpy array leaves (the HOST_ARGS scalars stay numpy, and
    tensors already on the card pass through)."""
    from foundationdb_tpu_torch import interop

    return sum(v.nbytes for k, v in args.items()
               if k not in interop.HOST_ARGS and isinstance(v, np.ndarray))


def args_copies(fn) -> list:
    """The bytes of each interop.device_args_to_torch call over fn()."""
    from foundationdb_tpu_torch import interop

    real, seen = interop.device_args_to_torch, []

    def counting(args, device):
        seen.append(args_bytes(args))
        return real(args, device)

    interop.device_args_to_torch = counting
    try:
        fn()
    finally:
        interop.device_args_to_torch = real
    return seen


def copy_timing(fn, n_batches: int, n_bytes: int) -> dict:
    """One argument copy: the wall to a sync, and the device time of its
    host-to-device copies by kind (a checked profiler session), per
    batch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    htod = {k: t / n_batches for k, t in profiled(fn).items()
            if k.startswith("Memcpy HtoD")}
    us = sum(htod.values())
    return {"bytes_per_batch": n_bytes / n_batches,
            "wall_ms_per_batch": wall * 1e3 / n_batches,
            "htod_us_per_batch": htod,
            "gb_per_s": n_bytes / n_batches / (us * 1e3) if us else None}


#: rounds of the staged / one-by-one comparison in phase 12
ROUNDS = 3


def shifted(batches, by: int) -> list:
    """The batches again with every version, floor and snapshot `by`
    later: the same conflicts replayed later in time."""
    import dataclasses

    return [dataclasses.replace(
        b, version=np.int32(int(b.version) + by),
        new_oldest=np.int32(int(b.new_oldest) + by),
        snapshot=(b.snapshot + np.int32(by)).astype(np.int32))
        for b in batches]


def no_pageable(tag: str, prof: dict) -> None:
    """The staged run's profile: host-to-device copies from pinned
    buffers only."""
    htod = prof["htod_ms_per_batch"]
    pageable = {k: v for k, v in htod.items() if "Pageable" in k}
    if pageable:
        fail(f"{tag}: pageable host-to-device copies in the staged chunks: "
             f"{pageable}")
    if not any("Pinned" in k for k in htod):
        fail(f"{tag}: no pinned host-to-device copy on record: {htod}")


def phase_pipeline(device, uni, uniform: dict, classic: dict) -> dict:
    """The staging pipeline on the card: phase 3's uniform batches
    through resolve_stream_pipelined (chunks of 8, depth 2) and phase
    6's classic groups of 8 through resolve_group_stream, every field
    identical to those phases' outputs, the staged chunks' copies pinned
    only; each beside the same batches dispatched one by one (pageable
    copies) with one sync at the end. Then the bytes each call of
    interop.device_args_to_torch copies on each path, one copy of each
    shape timed pageable and pinned, and stage_ledger at the bench
    shapes (fuse 8)."""
    import torch

    from foundationdb_tpu_torch import interop, make_conflict_set
    from foundationdb_tpu_torch.models.conflict_set import stage_ledger
    from foundationdb_tpu_torch.utils.packing import (
        group_args,
        stack_device_args,
    )

    def synced(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    n = len(uni)
    out = {}
    for tag, cfg in (("uniform", bench_config(B)),
                     ("classic", bench_config(B, delta_capacity=0))):
        classic_path = cfg.delta_capacity == 0
        groups = groups_of(uni) if classic_path else None
        cs = make_conflict_set(cfg, "cuda")
        torch.cuda.synchronize()
        reset_launches()
        res = []
        if classic_path:
            wall = synced(lambda: res.extend(cs.resolve_group_stream(groups)))
        else:
            wall = synced(lambda: res.extend(cs.resolve_stream_pipelined(
                uni, chunk=GROUP, depth=2)))
        launches, launch_bytes = launch_totals()
        unused = ("sweep_ranks", "read_dedup", *SHARDED_ONLY,
                  *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH)
        if classic_path:
            one_fold_a_batch(f"pipelined {tag}", launches, n)
            for gi, want in enumerate(classic["outs"]):
                same_fields(f"pipelined classic group {gi} vs phase 6",
                            verdict_fields(res[gi]), want)
        else:
            unused += CLASSIC_ONLY
            for i, want in enumerate(uniform["outs"]):
                gi, j = divmod(i, GROUP)
                same_fields(f"pipelined uniform batch {i} vs phase 3",
                            {f: getattr(res[gi], f)[j].cpu() for f in want},
                            want)
        require_launched(f"pipelined {tag}", launches, unused)
        c = cs.metrics.counters.as_dict()
        if not c["stagedChunks"] == len(res) > 0:
            fail(f"pipelined {tag}: {c['stagedChunks']} staged chunks for "
                 f"{len(res)} groups")
        ms = wall / n * 1e3
        # the same batches dispatched one by one, numpy args (pageable)
        ref = make_conflict_set(cfg, "cuda")
        if classic_path:
            ref_ms = synced(lambda: [ref.resolve_group_args(g)
                                     for g in groups]) / n * 1e3
        else:
            ref_ms = synced(lambda: [ref.resolve_packed(b)
                                     for b in uni]) / n * 1e3
        m = cs.metrics
        log(f"  {tag}: {n} batches x {B} txns in chunks of {GROUP}, every "
            f"field identical to phase {6 if classic_path else 3}; "
            f"{ms:.3f} ms/batch to one sync at the end, {B / ms * 1e3:,.0f}"
            f" txn/s (one by one, pageable, one sync: {ref_ms:.3f} "
            f"ms/batch); staging thread pack {m.pack.mean * 1e3:.3f} ms and "
            f"copy enqueue {m.transfer.mean * 1e3:.3f} ms a chunk; "
            f"launches {launches}")
        # the steady state: both sets warm (the staged one's pinned
        # slabs allocated), the first 16 batches replayed later in time,
        # staged and one by one in turns (staged first in even rounds)
        def runs(k: int):
            rb = shifted(uni[:2 * GROUP], (k + 1) * n * VERSION_STEP)
            if classic_path:
                rg = groups_of(rb)
                return (functools.partial(cs.resolve_group_stream, rg),
                        lambda: [ref.resolve_group_args(g) for g in rg])
            return (functools.partial(cs.resolve_stream_pipelined, rb,
                                      chunk=GROUP, depth=2),
                    lambda: [ref.resolve_packed(b) for b in rb])

        staged_ms, one_ms = [], []
        for k in range(ROUNDS):
            staged_run, one_run = runs(k)
            for which in ((0, 1) if k % 2 == 0 else (1, 0)):
                if which == 0:
                    staged_ms.append(synced(staged_run) / 16 * 1e3)
                else:
                    one_ms.append(synced(one_run) / 16 * 1e3)
        warm_ms = statistics.median(staged_ms)
        one_warm_ms = statistics.median(one_ms)
        log(f"  {tag}, warm, {ROUNDS} rounds of 16 batches in turns: staged "
            f"{warm_ms:.3f} ms/batch (median; {[round(x, 3) for x in staged_ms]}"
            f"), one by one {one_warm_ms:.3f} "
            f"({[round(x, 3) for x in one_ms]}); staging thread pack "
            f"{m.pack.mean * 1e3:.3f} ms and copy enqueue "
            f"{m.transfer.mean * 1e3:.3f} ms a chunk over the run")
        prof = profile_run(runs(ROUNDS)[0], warm_ms, 2 * GROUP)
        no_pageable(f"pipelined {tag}", prof)
        base = classic if classic_path else uniform
        log(f"  beside phase {6 if classic_path else 3}'s per-batch path: "
            f"{base['ms_per_batch']:.3f} ms/batch, idle share "
            f"{base['idle_share']:.3f}, host-to-device copies "
            f"{base['htod_ms_per_batch']} ms/batch")
        out[tag] = dict(launches=launches, launch_bytes=launch_bytes,
                        batches=n, ms_per_batch=ms, txn_per_s=B / ms * 1e3,
                        one_by_one_ms_per_batch=ref_ms,
                        warm_ms_per_batch=warm_ms,
                        warm_one_by_one_ms_per_batch=one_warm_ms,
                        warm_runs_ms_per_batch={"staged": staged_ms,
                                                "one_by_one": one_ms},
                        pack_ms_per_chunk=m.pack.mean * 1e3,
                        transfer_enqueue_ms_per_chunk=m.transfer.mean * 1e3,
                        staged_chunks=c["stagedChunks"], **prof)

    # the bytes each call of device_args_to_torch copies, on each path
    tcfg, ccfg = bench_config(B), bench_config(B, delta_capacity=0)
    t_one, c_one = make_conflict_set(tcfg, "cuda"), make_conflict_set(
        ccfg, "cuda")
    c_grp, staged = (make_conflict_set(ccfg, "cuda"),
                     make_conflict_set(tcfg, "cuda"))
    paths = {
        "tiered, one batch (resolve_packed; phase 3)":
            (lambda: t_one.resolve_packed(uni[0]), 1),
        "classic G = 1 (resolve_packed; phase 6's G = 1)":
            (lambda: c_one.resolve_packed(uni[0]), 1),
        "classic G = 8 (resolve_group_args; phase 6)":
            (lambda: c_grp.resolve_group_args(groups_of(uni[:GROUP])[0]),
             GROUP),
        "staged, chunks of 8 (resolve_stream_pipelined)":
            (lambda: staged.resolve_stream_pipelined(uni[:GROUP]), GROUP),
    }
    calls = {}
    for name, (fn, nb) in paths.items():
        seen = args_copies(fn)
        calls[name] = {"calls_per_batch": len(seen) / nb,
                       "bytes_per_call": seen,
                       "bytes_per_batch": sum(seen) / nb}
        log(f"  device_args_to_torch, {name}: {len(seen)} calls, bytes "
            f"{seen}")
    torch.cuda.synchronize()
    one = stack_device_args(uni[:1])
    grp = stack_device_args(uni[:GROUP])
    stager = interop.Stager(device, depth=1)
    # 256 MiB written on the host: what was in its caches is gone
    flush = np.empty(1 << 28, np.uint8)

    def evicted(args):
        def run():
            flush.fill(1)
            interop.device_args_to_torch(args, device)
        return run

    def pinned(args):
        def run():
            stager.receive(*stager.stage(args))
        return run

    copies = {
        "pageable, one batch": copy_timing(
            lambda: interop.device_args_to_torch(one, device), 1,
            args_bytes(one)),
        "pageable, a group of 8 stacked before": copy_timing(
            lambda: interop.device_args_to_torch(grp, device), GROUP,
            args_bytes(grp)),
        "pageable, a group of 8 stacked in the call": copy_timing(
            lambda: interop.device_args_to_torch(
                stack_device_args(uni[:GROUP]), device), GROUP,
            args_bytes(grp)),
        "pageable, one batch, host caches flushed first (the wall holds "
        "the 256 MiB flush)": copy_timing(
            evicted(one), 1, args_bytes(one)),
        "pinned (Stager), one batch": copy_timing(
            pinned(one), 1, args_bytes(one)),
        "pinned (Stager), a group of 8": copy_timing(
            pinned(grp), GROUP, args_bytes(grp)),
        "pinned (Stager), 8 batches stacked in the slab (the pipeline's "
        "pack and copy)": copy_timing(
            lambda: stager.receive(*stager.send(stager.fill(
                group_args(uni[:GROUP]), stack=True))), GROUP,
            args_bytes(grp)),
    }
    for name, row in copies.items():
        log(f"  copy {name}: {row}")

    # stage_ledger at the bench shapes: 2 groups of 8, on sets that
    # have taken one group before (the pipelined one its slabs)
    batches = uni[GROUP:3 * GROUP]
    dev_groups = [interop.device_args_to_torch(g, device)
                  for g in groups_of(uni[:3 * GROUP])]
    k_cs = make_conflict_set(tcfg, "cuda")
    k_cs.resolve_group_args(dev_groups[0], check_latch=False)
    kernel_s = synced(lambda: [k_cs.resolve_group_args(g, check_latch=False)
                               for g in dev_groups[1:]])
    p_cs = make_conflict_set(tcfg, "cuda")
    p_cs.resolve_stream_pipelined(uni[:GROUP], chunk=GROUP)
    pipelined_s = synced(lambda: p_cs.resolve_stream_pipelined(
        batches, chunk=GROUP))
    t0 = time.perf_counter()
    ledger = stage_ledger(tcfg, batches, fuse=GROUP, kernel_s=kernel_s,
                          pipelined_s=pipelined_s,
                          occupancy_delta_capacity=tcfg.history_capacity,
                          device=device)
    log(f"  stage_ledger (fuse {GROUP}, {len(batches)} batches, "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(ledger)}")
    out["args_copies"] = calls
    out["copies"] = copies
    out["stage_ledger"] = ledger
    return out


# ---------------------------------------------------------------------------
# phase 13: the Resolver role


def point_txns(gen, version: int, n: int) -> list:
    """n txns of one point read and one point write over KEYSPACE
    8-byte keys ([k, k + 1) on the integer keys, as the bench's), a
    snapshot up to SNAPSHOT_LAG behind, every third reporting."""
    from foundationdb_tpu_torch.models.types import CommitTransaction

    kv = gen.integers(0, KEYSPACE, (n, 2)).tolist()
    lag = gen.integers(1, SNAPSHOT_LAG, n).tolist()

    def key(i):
        return i.to_bytes(KEY_BYTES, "big")

    return [CommitTransaction([(key(a), key(a + 1))], [(key(b), key(b + 1))],
                              read_snapshot=version - d,
                              report_conflicting_keys=t % 3 == 0)
            for t, ((a, b), d) in enumerate(zip(kv, lag))]


def drive(res, req) -> tuple:
    """One request through the role on its scheduler: (reply, seconds)."""
    t0 = time.perf_counter()
    task = res.sched.spawn(res.resolve(req))
    reply = res.sched.run_until(task.done)
    return reply, time.perf_counter() - t0


def quantiles_ms(times: list) -> tuple:
    t = sorted(times)
    return (statistics.median(t) * 1e3,
            t[min(len(t) - 1, int(0.99 * len(t)))] * 1e3)


def phase_resolver(device, role_results: list) -> dict:
    """The Resolver role on the card. At the wire shape: 64 chained
    requests from two proxies (backend "cuda"), one carrying a state
    transaction and one replayed as a duplicate; every verdict and
    conflict report identical to phase 8's (which equal the copied
    ConflictOracle's). At full width: 8 requests of 65,536 txns through
    the knob-routed backend, which must be the card's TorchConflictSet;
    every verdict and report identical to a bare TorchConflictSet on the
    card, the first 2 to the CPU plain path."""
    import dataclasses

    import torch

    from foundationdb_tpu_torch import make_conflict_set
    from foundationdb_tpu_torch.config import KernelConfig
    from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet
    from foundationdb_tpu_torch.models.types import (
        ResolveTransactionBatchRequest as Request,
    )
    from foundationdb_tpu_torch.resolver import Resolver
    from foundationdb_tpu_torch.runtime.flow import Scheduler
    from foundationdb_tpu_torch.utils.knobs import SERVER_KNOBS

    out = {}
    cfg = KernelConfig(max_key_bytes=ROLE_KEY_BYTES, max_txns=ROLE_TXNS,
                       max_reads=ROLE_RANGES, max_writes=ROLE_RANGES,
                       history_capacity=ROLE_HISTORY,
                       window_versions=ROLE_WINDOW)
    res = Resolver(Scheduler(sim=True), cfg, backend="cuda",
                   commit_proxy_count=2)
    if not (isinstance(res.conflict_set, TorchConflictSet)
            and res.conflict_set.device == device):
        fail(f"Resolver(backend='cuda') built {res.conflict_set!r}")
    torch.cuda.synchronize()
    reset_launches()
    drive(res, Request(-1, 0, -1))
    state_at, dup_at = 4, 10
    mut = ("set", b"\xff/conf/resolvers", b"2")
    prev, seen, times, replies = 0, {}, [], []
    for i, (txns, version) in enumerate(role_stream(n=ROLE_BATCHES)):
        proxy = "AB"[i % 2]
        state_idx = []
        if i == state_at:
            txns = [dataclasses.replace(txns[0], mutations=[mut])] + txns[1:]
            state_idx = [0]
        req = Request(prev, version, seen.get(proxy, 0), txns, state_idx,
                      proxy_id=proxy)
        reply, dt = drive(res, req)
        times.append(dt)
        replies.append(reply)
        if i == dup_at:
            again, _ = drive(res, req)
            if again is not reply:
                fail("resolver role: a duplicate request was not answered "
                     "from the reply cache")
        seen[proxy], prev = version, version
    launches, launch_bytes = launch_totals()
    for i, (reply, (verdicts, reports)) in enumerate(zip(replies,
                                                         role_results)):
        if reply.committed != verdicts:
            fail(f"resolver role request {i}: verdicts differ from phase 8")
        if reply.conflicting_key_range_map != reports:
            fail(f"resolver role request {i}: conflict reports differ")
    forwarded = [s for group in replies[state_at + 1].state_mutations
                 for s in group if s.mutations == [mut]]
    if len(forwarded) != 1:
        fail("resolver role: the state transaction did not reach the other "
             "proxy")
    c = res.counters.as_dict()
    if (c["resolveBatchStart"], c["resolveBatchIn"]) != (
            ROLE_BATCHES + 1, ROLE_BATCHES + 2):
        fail(f"resolver role counters {c}")
    p50, p99 = quantiles_ms(times[1:])
    kernel = res.saturation()["kernel"]
    log(f"  wire shape: {ROLE_BATCHES} requests x {ROLE_TXNS} txns from 2 "
        f"proxies, a state transaction (forwarded, committed "
        f"{forwarded[0].committed}) and a replayed duplicate; verdicts and "
        f"reports identical to phase 8 and ConflictOracle; per request "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms (requests 1..); counters {c}; "
        f"kernel qos {json.dumps(kernel)}; launches {launches}")
    out["wire"] = dict(launches=launches, launch_bytes=launch_bytes,
                       batches=ROLE_BATCHES, p50_ms=p50, p99_ms=p99,
                       counters=c, kernel_qos=kernel)

    # full width: the knob-routed backend
    fcfg = bench_config(B)
    if (SERVER_KNOBS.RESOLVER_BACKEND != "cuda"
            or fcfg.max_txns < SERVER_KNOBS.RESOLVER_CUDA_MIN_BATCH):
        fail("the knob would not route a 65,536-txn config to the card")
    gen = np.random.default_rng(31)
    t0 = time.perf_counter()
    stream = [(point_txns(gen, v, B), v) for v in
              (SNAPSHOT_LAG + (i + 1) * VERSION_STEP for i in range(8))]
    make_s = time.perf_counter() - t0
    res = Resolver(Scheduler(sim=True), fcfg)
    bare = make_conflict_set(fcfg, "cuda")
    cpu = make_conflict_set(fcfg, "cuda", device="cpu")
    drive(res, Request(-1, 0, -1))
    bare.resolve([], 0)
    cpu.resolve([], 0)
    torch.cuda.synchronize()
    reset_launches()
    if not (isinstance(res.conflict_set, TorchConflictSet)
            and res.conflict_set.device == device):
        fail(f"the knob routed a {B}-txn config to {res.conflict_set!r}")
    prev, times, replies = 0, [], []
    for txns, version in stream:
        reply, dt = drive(res, Request(prev, version, prev, txns,
                                       proxy_id="p0"))
        times.append(dt)
        replies.append(reply)
        prev = version
    launches, launch_bytes = launch_totals()
    bare_times, n_conflict = [], 0
    for i, ((txns, version), reply) in enumerate(zip(stream, replies)):
        t0 = time.perf_counter()
        want = bare.resolve(txns, version)
        bare_times.append(time.perf_counter() - t0)
        if (reply.committed != want.verdicts
                or reply.conflicting_key_range_map
                != want.conflicting_key_ranges):
            fail(f"full-width request {i}: the Resolver differs from a bare "
                 "TorchConflictSet on the card")
        n_conflict += sum(int(v) == 0 for v in want.verdicts)
    t0 = time.perf_counter()
    for i, ((txns, version), reply) in enumerate(zip(stream[:2], replies)):
        want = cpu.resolve(txns, version)
        if (reply.committed != want.verdicts
                or reply.conflicting_key_range_map
                != want.conflicting_key_ranges):
            fail(f"full-width request {i}: the Resolver differs from the "
                 "CPU plain path")
    cpu_s = time.perf_counter() - t0
    if n_conflict == 0:
        fail("the full-width stream produced no conflicts")
    p50, p99 = quantiles_ms(times)
    b50, b99 = quantiles_ms(bare_times)
    log(f"  full width: 8 requests x {B} txns (made in {make_s:.1f} s), "
        f"routed by the knob to {type(res.conflict_set).__name__} on "
        f"{res.conflict_set.device}; identical to a bare TorchConflictSet "
        f"on the card ({n_conflict} conflicts) and, requests 0-1, to the "
        f"CPU plain path ({cpu_s:.1f} s); per request p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms (bare resolve() p50 {b50:.3f}, p99 {b99:.3f}); "
        f"launches {launches}")
    out["full_width"] = dict(launches=launches, launch_bytes=launch_bytes,
                             batches=len(stream), p50_ms=p50, p99_ms=p99,
                             bare_p50_ms=b50, bare_p99_ms=b99,
                             conflicts=n_conflict,
                             kernel_qos=res.saturation()["kernel"])
    # phase 14 sends the same requests over the wire
    out["full_width_inputs"] = (stream, [
        (r.committed, r.conflicting_key_range_map) for r in replies])
    return out


# ---------------------------------------------------------------------------
# phase 14: the wire resolver

#: versions a second pass over phase 8's batches is shifted by: past the
#: window, so the first pass's history can neither conflict with it nor
#: outlive its first batch
WIRE_SHIFT = ROLE_WINDOW + 70 * ROLE_VERSION_STEP
WIRE_CHILDREN = ("WC", "W2a", "W2b", "WF")
#: the kernels the wire role's default config (classic, G = 1) launches a
#: fixed number of times a batch, whatever the batch holds: A's counts
#: and probe, D, and the two sorts (L, N)
WIRE_PER_BATCH = ("keysearch.counts", "keysearch.probe", "merge_maps",
                  "sort_ranks", "lex_order")


def shift_stream(stream, by: int) -> list:
    import dataclasses

    return [([dataclasses.replace(t, read_snapshot=t.read_snapshot + by)
              for t in txns], version + by) for txns, version in stream]


def combine_clipped(txns, ranges, replies) -> tuple:
    """The proxy's min-combine of the resolvers' replies to one clipped
    batch: each verdict the least of its slot's, each resolver's
    reported read indices mapped back to the unclipped transaction and
    merged, kept where the combined verdict is a conflict (the
    MultiResolverOracle's rule)."""
    n = len(txns)
    verdict = [min(int(r.committed[t]) for r in replies) for t in range(n)]
    merged: dict = {}
    for (lo, hi), rep in zip(ranges, replies):
        for t, idxs in rep.conflicting_key_range_map.items():
            kept = [i for i, (b, e) in enumerate(txns[t].read_conflict_ranges)
                    if max(b, lo) < (e if hi is None else min(e, hi))]
            merged.setdefault(t, set()).update(kept[i] for i in idxs)
    return verdict, {t: sorted(v) for t, v in merged.items()
                     if verdict[t] == 0}


def dist_ms(d: dict) -> dict:
    """A status LatencySample (seconds) as p50 / p99 / count in ms."""
    return dict(p50_ms=d["p50"] * 1e3, p99_ms=d["p99"] * 1e3,
                count=d["count"])


def phase_wire(role: dict, role_results: list, resolver: dict) -> dict:
    """Four port resolver processes (`cluster/multiprocess.spawn_role`,
    backend "cuda" on the card), spawned at once after the kernels are
    built, reached over Unix sockets with the wire codec's frames:

    * WC, the wire role's default config: phase 8's 64 batches as
      columnar frames, chained, every verdict and report identical to
      phase 8's; a duplicate answered from the cache; a request at a
      stale epoch refused; its status (64 columnar batches, 128 copies,
      the kernels launched exactly as often as in phase 8); then the
      same batches as object frames, shifted past the window, identical
      again, with the same launches;
    * W2, two such processes: phase 8's batches clipped to the keyspace
      halves of default_resolver_boundaries(2), and again at the middle
      of phase 8's keyspace (phase 8's keys share one first byte, so the
      default split gives the second process empty slots), min-combined
      here, identical to the MultiResolverOracle; each child launches
      phase 8's kernels, those of WIRE_PER_BATCH phase 8's count a batch
      for each of its requests;
    * WF, phase 13's full-width config (RESOLVER_KERNEL): phase 13's 8
      requests of 65,536 txns as columnar frames after the same empty
      first request, identical to phase 13's replies, the kernels
      launched exactly as often as in phase 13.

    Every child is stopped on the way out, whatever happened."""
    import asyncio
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from foundationdb_tpu_torch.cluster import generation
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.config import KernelConfig
    from foundationdb_tpu_torch.models.types import (
        ResolveTransactionBatchRequest as Request,
    )
    from foundationdb_tpu_torch.testing.oracle import (
        MultiResolverOracle,
        OracleTxn,
    )
    from foundationdb_tpu_torch.utils import packing
    from foundationdb_tpu_torch.wire import codec, transport

    wc_cfg = KernelConfig(max_key_bytes=ROLE_KEY_BYTES, max_txns=ROLE_TXNS,
                          max_reads=ROLE_RANGES, max_writes=ROLE_RANGES,
                          history_capacity=ROLE_HISTORY,
                          window_versions=ROLE_WINDOW)
    wf_cfg = bench_config(B)
    wf_stream, wf_want = resolver.pop("full_width_inputs")
    stream = role_stream(n=ROLE_BATCHES)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the children's tiers share the card
    sock_dir = tempfile.mkdtemp(prefix="fdbw")
    rel = os.path.relpath(sock_dir)
    if len(rel) < len(sock_dir):
        sock_dir = rel  # a Unix socket path holds at most 107 bytes
    out: dict = {}

    async def drive_children(procs, t_spawn):
        conns: dict = {}

        async def up(name):
            conns[name] = await mp.connect(procs[name].address,
                                           proc=procs[name])
            await conns[name].call(mp.TOKEN_PING, mp.Ping(payload=b"up"))
            return time.perf_counter() - t_spawn

        async def status(name):
            rep = await conns[name].call(mp.TOKEN_STATUS,
                                         mp.StatusRequest(pad=0))
            return json.loads(rep.payload)

        async def call(name, req):
            t0 = time.perf_counter()
            rep = await conns[name].call(mp.TOKEN_RESOLVE, req)
            return rep, time.perf_counter() - t0

        def launches(after, before):
            """The child's kernel launches between two status reads
            (the kernels it launched at all)."""
            a, b = after["kernel_launches"], before["kernel_launches"]
            return {k: a[k] - b[k] for k in a if a[k] != b[k]}

        def launched(counts):
            return {k: v for k, v in counts.items() if v}

        def check_w2_launches(name, counts, requests):
            """A W2 child launches the kernels phase 8 launched, and those
            that run a fixed number of times a batch (WIRE_PER_BATCH)
            exactly phase 8's count a batch times its requests; B, A's
            query and C follow the data."""
            want = launched(role["launches"])
            if set(counts) != set(want):
                fail(f"wire {name} launched {sorted(counts)}, phase 8 "
                     f"{sorted(want)}")
            for k in WIRE_PER_BATCH:
                per, rest = divmod(want[k], ROLE_BATCHES)
                if rest or counts[k] != per * requests:
                    fail(f"wire {name}: {k} launched {counts[k]} times in "
                         f"{requests} requests, phase 8 {want[k]} in "
                         f"{ROLE_BATCHES} batches")

        def children_alive():
            for name, p in procs.items():
                if p.exited() is not None:
                    fail(f"wire resolver {name} exited with code "
                         f"{p.exited()}")

        try:
            firsts = await asyncio.gather(*(up(n) for n in WIRE_CHILDREN))
            started = dict(zip(WIRE_CHILDREN, firsts))
            st0 = {n: await status(n) for n in WIRE_CHILDREN}
            warm = {n: st0[n]["qos"]["kernel"]["compile_seconds"]
                    for n in WIRE_CHILDREN}
            for n in WIRE_CHILDREN:
                if st0[n]["qos"]["kernel_stages"]["warmCompiles"] != 1:
                    fail(f"wire resolver {n} did not warm up once")
            log("  children up (spawn to first answer, s): "
                + ", ".join(f"{n} {started[n]:.2f}" for n in WIRE_CHILDREN)
                + "; warm-up (s): "
                + ", ".join(f"{n} {warm[n]:.2f}" for n in WIRE_CHILDREN))

            # -- WC: columnar frames -----------------------------------
            rtt, pack_ms, enc_ms, dec_ms, pbc_ms, replies = [], [], [], \
                [], [], []
            prev = -1
            for i, (txns, version) in enumerate(stream):
                t0 = time.perf_counter()
                cols = packing.pack_columnar(txns)
                t1 = time.perf_counter()
                req = codec.ResolveBatchColumnar(prev, version, prev, cols,
                                                 proxy_id="p0")
                raw = codec.encode(req)
                t2 = time.perf_counter()
                rep, dt = await call("WC", req)
                t3 = time.perf_counter()
                dec = codec.decode(raw)
                t4 = time.perf_counter()
                packing.pack_batch_columnar(dec.cols, version, 0, wc_cfg)
                t5 = time.perf_counter()
                pack_ms.append((t1 - t0) * 1e3)
                enc_ms.append((t2 - t1) * 1e3)
                dec_ms.append((t4 - t3) * 1e3)
                pbc_ms.append((t5 - t4) * 1e3)
                rtt.append(dt)
                verdicts, reports = role_results[i]
                if rep.committed != verdicts:
                    fail(f"wire WC request {i}: verdicts differ from phase 8")
                if rep.conflicting_key_range_map != reports:
                    fail(f"wire WC request {i}: conflict reports differ from "
                         "phase 8")
                replies.append(rep)
                prev = version
            dup_at = ROLE_BATCHES - 5  # inside the role's replay window
            txns, version = stream[dup_at]
            again, _ = await call("WC", codec.ResolveBatchColumnar(
                stream[dup_at - 1][1], version, prev,
                packing.pack_columnar(txns), proxy_id="p0"))
            if codec.encode(again) != codec.encode(replies[dup_at]):
                fail("wire WC: the duplicate's reply differs")
            try:
                await call("WC", codec.ResolveBatchColumnar(
                    prev, prev + ROLE_VERSION_STEP, prev,
                    packing.pack_columnar(stream[0][0]), epoch=7))
            except transport.RemoteError as e:
                if not generation.is_stale_epoch(e):
                    fail(f"wire WC: the stale request failed otherwise: {e}")
            else:
                fail("wire WC: a request at a stale epoch was resolved")
            st1 = await status("WC")
            path1 = dict(st1["qos"]["resolve_path"])
            stages = st1["qos"]["kernel_stages"]
            if (stages["columnarBatches"], path1["columnar_batches"],
                    path1["copies"], st1["qos"]["stale_epoch_rejects"]) != (
                    ROLE_BATCHES, ROLE_BATCHES, 2 * ROLE_BATCHES, 1):
                fail(f"wire WC status: columnarBatches "
                     f"{stages['columnarBatches']}, path {path1}, stale "
                     f"rejects {st1['qos']['stale_epoch_rejects']}")
            wc_launch = launches(st1, st0["WC"])
            if wc_launch != launched(role["launches"]):
                fail(f"wire WC launched {wc_launch}, phase 8 "
                     f"{launched(role['launches'])}")
            p50, p99 = quantiles_ms(rtt)
            out["WC"] = dict(
                batches=ROLE_BATCHES, frame="columnar", rtt_p50_ms=p50,
                rtt_p99_ms=p99, phase8_resolve_p50_ms=role["p50_ms"],
                phase8_resolve_p99_ms=role["p99_ms"],
                compute_time=dist_ms(st1["qos"]["compute_time_dist"]),
                proxy_pack_columnar_p50_ms=statistics.median(pack_ms),
                proxy_encode_p50_ms=statistics.median(enc_ms),
                role_decode_p50_ms=statistics.median(dec_ms),
                role_pack_batch_columnar_p50_ms=statistics.median(pbc_ms),
                child_pack_p50_ms=stages["packSeconds"]["p50"] * 1e3,
                path_stats=path1, launches=wc_launch)
            log(f"  WC: {ROLE_BATCHES} columnar requests x {ROLE_TXNS} txns "
                f"identical to phase 8 (reports included), a duplicate "
                f"from the cache, the stale epoch refused; round trip p50 "
                f"{p50:.3f} ms, p99 {p99:.3f} ms (phase 8's bare resolve() "
                f"p50 {role['p50_ms']:.3f}, p99 {role['p99_ms']:.3f}); role "
                f"compute {json.dumps(out['WC']['compute_time'])}; proxy "
                f"pack_columnar {out['WC']['proxy_pack_columnar_p50_ms']:.3f}"
                f" + encode {out['WC']['proxy_encode_p50_ms']:.3f} ms; role "
                f"decode {out['WC']['role_decode_p50_ms']:.3f} + "
                f"pack_batch_columnar "
                f"{out['WC']['role_pack_batch_columnar_p50_ms']:.3f} ms "
                f"(here), child pack p50 "
                f"{out['WC']['child_pack_p50_ms']:.3f} ms; path {path1}; "
                f"launches {wc_launch} (phase 8's)")

            # -- WC: the same batches as object frames, past the window --
            children_alive()
            rtt = []
            for i, (txns, version) in enumerate(shift_stream(stream,
                                                             WIRE_SHIFT)):
                rep, dt = await call("WC", Request(prev, version, prev, txns,
                                                   proxy_id="p0"))
                rtt.append(dt)
                verdicts, reports = role_results[i]
                if (rep.committed != verdicts
                        or rep.conflicting_key_range_map != reports):
                    fail(f"wire WC object request {i} differs from phase 8")
                prev = version
            st2 = await status("WC")
            path2 = dict(st2["qos"]["resolve_path"])
            obj = {k: path2[k] - path1[k] for k in path2}
            if obj["object_batches"] != ROLE_BATCHES or obj["copies"] != (
                    3 * ROLE_BATCHES):
                fail(f"wire WC object frames: path {obj}")
            obj_launch = launches(st2, st1)
            if obj_launch != wc_launch:
                fail(f"wire WC object frames launched {obj_launch}, the "
                     f"columnar ones {wc_launch}")
            p50, p99 = quantiles_ms(rtt)
            out["WC_object"] = dict(
                batches=ROLE_BATCHES, frame="object", rtt_p50_ms=p50,
                rtt_p99_ms=p99, path_stats=obj, launches=obj_launch)
            log(f"  WC object frames: the same {ROLE_BATCHES} batches "
                f"{WIRE_SHIFT} versions later, identical; round trip p50 "
                f"{p50:.3f} ms, p99 {p99:.3f} ms; path {obj}")

            # -- W2: two processes over a split keyspace -----------------
            children_alive()
            w2 = {}
            prev = -1
            middle = b"\x02tbl/" + (ROLE_KEYSPACE // 2).to_bytes(10, "big")
            for label, bounds, by in (
                    ("default", mp.default_resolver_boundaries(2), 0),
                    ("middle", [middle], WIRE_SHIFT)):
                ranges = mp.resolver_key_ranges(bounds)
                oracle = MultiResolverOracle(bounds, window=ROLE_WINDOW)
                rtt, shares = [], [0, 0]
                for i, (txns, version) in enumerate(shift_stream(stream, by)):
                    parts = [mp.clip_transactions(txns, lo, hi)
                             for lo, hi in ranges]
                    for s_, part in enumerate(parts):
                        shares[s_] += sum(len(t.read_conflict_ranges)
                                          + len(t.write_conflict_ranges)
                                          for t in part)
                    t0 = time.perf_counter()
                    reps = await asyncio.gather(*(
                        conns[n].call(mp.TOKEN_RESOLVE,
                                      codec.ResolveBatchColumnar(
                                          prev, version, prev,
                                          packing.pack_columnar(part),
                                          proxy_id="p0"))
                        for n, part in zip(("W2a", "W2b"), parts)))
                    rtt.append(time.perf_counter() - t0)
                    verdict, ckr = combine_clipped(txns, ranges, reps)
                    want = oracle.resolve(
                        [OracleTxn(t.read_conflict_ranges,
                                   t.write_conflict_ranges, t.read_snapshot,
                                   t.report_conflicting_keys)
                         for t in txns], version)
                    if verdict != list(want.verdicts):
                        fail(f"wire W2 ({label}) batch {i}: verdicts differ "
                             "from MultiResolverOracle")
                    if ckr != want.conflicting_ranges:
                        fail(f"wire W2 ({label}) batch {i}: conflict reports "
                             "differ from MultiResolverOracle")
                    prev = version
                p50, p99 = quantiles_ms(rtt)
                w2[label] = dict(boundaries=[b.hex() for b in bounds],
                                 ranges_per_resolver=shares,
                                 rtt_p50_ms=p50, rtt_p99_ms=p99)
                log(f"  W2 split at {[b.hex() for b in bounds]}: "
                    f"{ROLE_BATCHES} batches identical to "
                    f"MultiResolverOracle; ranges per resolver {shares}; "
                    f"both round trips p50 {p50:.3f} ms, p99 {p99:.3f} ms")
            st_w2 = {n: await status(n) for n in ("W2a", "W2b")}
            for n in ("W2a", "W2b"):
                check_w2_launches(n, launches(st_w2[n], st0[n]),
                                  2 * ROLE_BATCHES)
            out["W2"] = dict(**w2, **{
                n: dict(compute_time=dist_ms(
                    st_w2[n]["qos"]["compute_time_dist"]),
                    path_stats=st_w2[n]["qos"]["resolve_path"],
                    launches=launches(st_w2[n], st0[n]))
                for n in ("W2a", "W2b")})

            # -- WF: full width --------------------------------------------
            children_alive()
            rtt, pack_ms, enc_ms, dec_ms, pbc_ms = [], [], [], [], []
            await call("WF", codec.ResolveBatchColumnar(
                -1, 0, -1, packing.pack_columnar([]), proxy_id="p0"))
            st_f0 = await status("WF")
            prev = 0
            for i, (txns, version) in enumerate(wf_stream):
                t0 = time.perf_counter()
                cols = packing.pack_columnar(txns)
                t1 = time.perf_counter()
                req = codec.ResolveBatchColumnar(prev, version, prev, cols,
                                                 proxy_id="p0")
                raw = codec.encode(req)
                t2 = time.perf_counter()
                rep, dt = await call("WF", req)
                t3 = time.perf_counter()
                dec = codec.decode(raw)
                t4 = time.perf_counter()
                packing.pack_batch_columnar(dec.cols, version, 0, wf_cfg)
                t5 = time.perf_counter()
                pack_ms.append((t1 - t0) * 1e3)
                enc_ms.append((t2 - t1) * 1e3)
                dec_ms.append((t4 - t3) * 1e3)
                pbc_ms.append((t5 - t4) * 1e3)
                rtt.append(dt)
                committed, reports = wf_want[i]
                if (rep.committed != committed
                        or rep.conflicting_key_range_map != reports):
                    fail(f"wire WF request {i}: differs from phase 13")
                prev = version
            st_f = await status("WF")
            wf_launch = launches(st_f, st_f0)
            full = resolver["full_width"]
            if wf_launch != launched(full["launches"]):
                fail(f"wire WF launched {wf_launch}, phase 13 "
                     f"{launched(full['launches'])}")
            p50, p99 = quantiles_ms(rtt)
            out["WF"] = dict(
                batches=len(wf_stream), frame="columnar", rtt_p50_ms=p50,
                rtt_p99_ms=p99, phase13_resolver_p50_ms=full["p50_ms"],
                phase13_resolver_p99_ms=full["p99_ms"],
                phase13_bare_p50_ms=full["bare_p50_ms"],
                phase13_bare_p99_ms=full["bare_p99_ms"],
                compute_time=dist_ms(st_f["qos"]["compute_time_dist"]),
                proxy_pack_columnar_p50_ms=statistics.median(pack_ms),
                proxy_encode_p50_ms=statistics.median(enc_ms),
                role_decode_p50_ms=statistics.median(dec_ms),
                role_pack_batch_columnar_p50_ms=statistics.median(pbc_ms),
                child_pack_p50_ms=st_f["qos"]["kernel_stages"][
                    "packSeconds"]["p50"] * 1e3,
                path_stats=st_f["qos"]["resolve_path"], launches=wf_launch)
            log(f"  WF: {len(wf_stream)} columnar requests x {B} txns "
                f"identical to phase 13; round trip p50 {p50:.3f} ms, p99 "
                f"{p99:.3f} ms (phase 13: Resolver p50 {full['p50_ms']:.3f},"
                f" p99 {full['p99_ms']:.3f}; bare resolve() p50 "
                f"{full['bare_p50_ms']:.3f}, p99 {full['bare_p99_ms']:.3f});"
                f" role compute {json.dumps(out['WF']['compute_time'])}; "
                f"proxy pack_columnar "
                f"{out['WF']['proxy_pack_columnar_p50_ms']:.3f} + encode "
                f"{out['WF']['proxy_encode_p50_ms']:.3f} ms; role decode "
                f"{out['WF']['role_decode_p50_ms']:.3f} + "
                f"pack_batch_columnar "
                f"{out['WF']['role_pack_batch_columnar_p50_ms']:.3f} ms "
                f"(here), child pack p50 "
                f"{out['WF']['child_pack_p50_ms']:.3f} ms; launches "
                f"{wf_launch} (phase 13's)")
            out["children"] = {n: dict(spawn_to_first_answer_s=started[n],
                                       warm_up_s=warm[n])
                               for n in WIRE_CHILDREN}
            children_alive()
        finally:
            for c in conns.values():
                await c.close()

    procs = {}
    try:
        t_spawn = time.perf_counter()
        for i, name in enumerate(WIRE_CHILDREN):
            procs[name] = mp.spawn_role(
                "resolver", sock_dir, index=i,
                env={"RESOLVER_KERNEL": repr(wf_cfg) if name == "WF"
                     else ""})
        asyncio.run(drive_children(procs, t_spawn))
    finally:
        for p in procs.values():
            p.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the commit path

#: the cut of scale (YCSB's own runs load millions of records): enough for
#: a load through one Python proxy to finish inside the phase's time
COMMIT_RECORDS = 100_000
COMMIT_FIELDS = 10          # YCSB's default record: ten 100-byte fields
COMMIT_FIELD_BYTES = 100
COMMIT_CLIENTS = 256
COMMIT_OPS = 40             # operations a client
COMMIT_RETRIES = 8          # a conflicted update is tried again this often
COMMIT_ZIPF = 0.99          # YCSB's zipfian constant
COMMIT_TXNS = 4096          # the pipeline's max_batch and the kernel's batch
COMMIT_BATCH_INTERVAL = 0.001
COMMIT_CHILDREN = ("resolver", "tlog", "storage")
#: the kernels the tiered path launches a fixed number of times a batch
#: (merge_maps is one a batch and one a compaction)
TIERED_PER_BATCH = ("keysearch.counts", "keysearch.probe", "sort_ranks",
                    "lex_order")


def commit_config(n: int = COMMIT_TXNS):
    """The resolver child's config: the tiered main path at n txns, with
    16-byte keys (b"user%010d" is 14 bytes, its end key 15), the
    5,000,000-version window, a 2^20-row main tier (100,000 loaded keys
    are about 200,000 boundaries) and a 2^17-row delta tier (bench's 12 x
    n rows would not hold the 2 x n rows a full load batch adds over the
    compaction interval's 8 batches)."""
    return bench_config(n, max_key_bytes=16, history_capacity=1 << 20,
                        delta_capacity=1 << 17, window_versions=ROLE_WINDOW)


def ycsb_a_inputs(seed: int, records: int, clients: int, ops: int) -> dict:
    """YCSB's load and workload A from one seed: the records (key
    b"user%010d", ten random 100-byte fields, the first field's 8 leading
    bytes the read-modify-write counter, 0), inserted in a seeded order
    (YCSB's hashed insert order), and for each client `ops` operations,
    half reads and half read-modify-write updates, over a scrambled
    zipfian (constant 0.99) choice of records."""
    gen = np.random.default_rng(seed)
    width = COMMIT_FIELDS * COMMIT_FIELD_BYTES
    body = gen.integers(0, 256, (records, width), dtype=np.uint8)
    body[:, :8] = 0
    weights = 1.0 / np.arange(1, records + 1, dtype=np.float64) ** COMMIT_ZIPF
    scramble = gen.permutation(records)
    picks = scramble[gen.choice(records, size=(clients, ops),
                                p=weights / weights.sum())]
    return dict(
        keys=[b"user%010d" % i for i in range(records)],
        values=[body[i].tobytes() for i in range(records)],
        insert_order=gen.permutation(records).tolist(),
        record=picks.tolist(),
        is_read=(gen.random((clients, ops)) < 0.5).tolist(),
        field=gen.integers(1, COMMIT_FIELDS, (clients, ops)).tolist(),
        new_field=gen.integers(0, 256, (clients, ops, COMMIT_FIELD_BYTES),
                               dtype=np.uint8))


def phase_commit_path(card: str, *, records: int = COMMIT_RECORDS,
                      clients: int = COMMIT_CLIENTS, ops: int = COMMIT_OPS,
                      kernel_cfg=None, device=None, seed: int = 15,
                      encrypt: bool = False, kill_storage: bool = False,
                      label: str = "commit path") -> dict:
    """The port's commit path end to end: three port children
    (`cluster/multiprocess.spawn_role`: a "cuda" resolver on the card
    with `commit_config()` through RESOLVER_KERNEL, and a tlog and a
    storage on data dirs of their own, the memory engine) and the port's
    ProxyPipeline in this process (max_batch 4,096, batch_interval 1 ms,
    as scripts/bench_mp_pipeline.py runs it), through the entry points a
    client calls (get_read_version, read, commit). YCSB's load (one
    insert a transaction), then workload A from 256 clients.

    The resolver and tlog connections are thin recording subclasses of
    the transport's connection. It fails unless every resolver reply is
    the copied ConflictOracle's on the same requests replayed in version
    order, the storage snapshot at the last committed version is the
    replay of the committed mutations, each record's counter is its
    committed updates, every tlog push is its batch's committed
    mutations and the tlog's entries are the pushes past its last pop,
    and no batch failed. The launches are checked by the caller
    (`check_commit_launches`). Every child is stopped on the way out.

    With `encrypt` the tlog and the storage are sealed
    (`spawn_role(..., encrypt=True)`; their keys from the REST KMS at
    FDB_TPU_KMS, else the sim KMS), a sentinel value is committed before
    workload A, and it also fails if the sentinel or any of SE_SAMPLES
    loaded values is in any file of either data dir after the run, or if
    a StorageRole or TLogRole on those dirs opens without encryption. With
    `kill_storage` the storage child is killed with SIGKILL between
    workload A's halves (its applies drained, nothing in flight) and
    started again on its data dir (caught up from the tlog): it fails
    unless that child's snapshot at the last acknowledged version is the
    replay of the commits so far and, sealed, unless it fetched its keys
    from the KMS and opened every value it served. The connections use
    mutual TLS when FDB_TPU_TLS_DIR is set (the caller's)."""
    import asyncio
    import shutil
    import tempfile

    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.utils import packing
    from foundationdb_tpu_torch.wire import transport
    from foundationdb_tpu_torch.wire.codec import Mutation

    cfg = kernel_cfg or commit_config()
    log(f"  cut: {records} records of {COMMIT_FIELDS} x "
        f"{COMMIT_FIELD_BYTES} bytes (YCSB's own loads hold millions: the "
        f"load runs through one Python proxy inside the phase's time); "
        f"{clients} clients x {ops} operations of workload A; resolver "
        f"RESOLVER_KERNEL={cfg!r}")

    class Recording(transport.RpcConnection):
        """The transport's connection, keeping (token, request, reply)
        of every call of `tokens` this script's pipeline makes (the
        reply None while it has not come, as for a pop the pipeline's
        stop cancels)."""

        def __init__(self, address, tokens):
            super().__init__(address, tls=mp._tls_from_env())
            self.tokens, self.calls = tokens, []

        async def call(self, token, msg, **kw):
            if token not in self.tokens:
                return await super().call(token, msg, **kw)
            entry = [token, msg, None]
            self.calls.append(entry)
            entry[2] = await super().call(token, msg, **kw)
            return entry[2]

    work = tempfile.mkdtemp(prefix="fdbc")
    rel = os.path.relpath(work)
    if len(rel) < len(work):
        work = rel  # a Unix socket path holds at most 107 bytes
    t_spawn = time.perf_counter()
    data_dirs = {n: os.path.join(work, f"{n}-data")
                 for n in ("tlog", "storage")}
    procs = {
        "resolver": mp.spawn_role("resolver", work, device=device,
                                  env={"RESOLVER_KERNEL": repr(cfg)}),
        "tlog": mp.spawn_role("tlog", work, data_dir=data_dirs["tlog"],
                              encrypt=encrypt),
        "storage": mp.spawn_role("storage", work,
                                 data_dir=data_dirs["storage"],
                                 encrypt=encrypt),
    }
    inputs = ycsb_a_inputs(seed, records, clients, ops)
    keys, values = inputs["keys"], inputs["values"]
    out: dict = {"records": records, "clients": clients, "ops": ops,
                 "card": card, "encrypt": encrypt,
                 "kill_storage": kill_storage}

    async def drive():
        started = {}

        async def up(name):
            c = await mp.connect(procs[name].address, proc=procs[name])
            await c.call(mp.TOKEN_PING, mp.Ping(payload=b"up"))
            started[name] = time.perf_counter() - t_spawn
            return c

        plain = dict(zip(COMMIT_CHILDREN, await asyncio.gather(
            *(up(n) for n in COMMIT_CHILDREN))))

        async def status(name):
            rep = await plain[name].call(mp.TOKEN_STATUS,
                                         mp.StatusRequest(pad=0))
            return json.loads(rep.payload)

        st0 = await status("resolver")
        res = Recording(procs["resolver"].address, {mp.TOKEN_RESOLVE})
        tlog = Recording(procs["tlog"].address,
                         {mp.TOKEN_TLOG_PUSH, mp.TOKEN_TLOG_POP})
        storage = transport.RpcConnection(procs["storage"].address,
                                          tls=mp._tls_from_env())
        for c in (res, tlog, storage):
            await c.connect()
        conns = {"storage": storage}
        pipe = mp.ProxyPipeline([res], tlog, storage, max_batch=cfg.max_txns,
                                batch_interval=COMMIT_BATCH_INTERVAL)
        pipe.start()
        committed = []  # (version, key, value) of every committed txn

        # -- YCSB load: one insert a transaction, all offered at once
        t0 = time.perf_counter()

        async def insert(i):
            k = keys[i]
            v = await pipe.commit(CommitTransaction(
                write_conflict_ranges=[(k, k + b"\x00")],
                mutations=[Mutation(0, k, values[i])]))
            committed.append((v, k, values[i]))

        await asyncio.gather(*(insert(i) for i in inputs["insert_order"]))
        load_s = time.perf_counter() - t0
        load_batches = len(res.calls)
        out["load"] = dict(seconds=load_s, commits_per_s=records / load_s,
                           batches=load_batches,
                           mean_batch_txns=records / load_batches)
        log(f"  load: {records} inserts in {load_s:.3f} s "
            f"({records / load_s:.1f} commits/s, {load_batches} batches, "
            f"mean {records / load_batches:.1f} txns) on {card}")

        if encrypt:
            # a value the disk scan looks for after the run
            v = await pipe.commit(CommitTransaction(
                write_conflict_ranges=[(SE_SENTINEL_KEY,
                                        SE_SENTINEL_KEY + b"\x00")],
                mutations=[Mutation(0, SE_SENTINEL_KEY, SE_SENTINEL)]))
            committed.append((v, SE_SENTINEL_KEY, SE_SENTINEL))

        # -- YCSB workload A
        grv_s, read_s, commit_s = [], [], []
        counts = dict(reads=0, updates=0, conflicts=0, gave_up=0)
        updates = [0] * records

        async def kill_restart() -> dict:
            """SIGKILL the storage child once its applies drained, start
            it again on its data dir (a catch-up from the tlog first), and
            point the pipeline at it; its snapshot at the head then."""
            while pipe.applied_version < pipe.committed_version:
                await asyncio.sleep(0.001)
            head_k = pipe.committed_version
            before = await status("storage")
            procs["storage"].proc.kill()
            procs["storage"].proc.wait()
            for c in (plain["storage"], conns["storage"]):
                await c.close()
            if os.path.exists(procs["storage"].address):
                os.unlink(procs["storage"].address)
            t0 = time.perf_counter()
            procs["storage"] = mp.spawn_role(
                "storage", work, data_dir=data_dirs["storage"],
                encrypt=encrypt, tlog_address=procs["tlog"].address)
            plain["storage"] = await mp.connect(procs["storage"].address,
                                                proc=procs["storage"])
            up_s = time.perf_counter() - t0
            conns["storage"] = transport.RpcConnection(
                procs["storage"].address, tls=mp._tls_from_env())
            await conns["storage"].connect()
            pipe.storage = conns["storage"]
            t1 = time.perf_counter()
            snap_k = await conns["storage"].call(
                mp.TOKEN_STORAGE_SNAPSHOT,
                mp.StorageSnapshotReq(version=head_k), timeout=300.0)
            return dict(head=head_k, committed=list(committed),
                        snapshot=snap_k, before=before,
                        after=await status("storage"), restart_s=up_s,
                        snapshot_s=time.perf_counter() - t1)

        async def client(c, lo=0, hi=ops):
            for j in range(lo, hi):
                rid = inputs["record"][c][j]
                key = keys[rid]
                for _attempt in range(1 + COMMIT_RETRIES):
                    t0 = time.perf_counter()
                    rv = await pipe.get_read_version()
                    t1 = time.perf_counter()
                    cur = await pipe.read(key, rv)
                    t2 = time.perf_counter()
                    grv_s.append(t1 - t0)
                    read_s.append(t2 - t1)
                    if cur is None or len(cur) != len(values[rid]):
                        fail(f"{label}: record {rid} read {cur!r:.40}")
                    if inputs["is_read"][c][j]:
                        counts["reads"] += 1
                        break
                    f = inputs["field"][c][j] * COMMIT_FIELD_BYTES
                    new = ((int.from_bytes(cur[:8], "little") + 1)
                           .to_bytes(8, "little") + cur[8:f]
                           + inputs["new_field"][c, j].tobytes()
                           + cur[f + COMMIT_FIELD_BYTES:])
                    kr = (key, key + b"\x00")
                    t3 = time.perf_counter()
                    try:
                        v = await pipe.commit(CommitTransaction(
                            read_conflict_ranges=[kr],
                            write_conflict_ranges=[kr], read_snapshot=rv,
                            mutations=[Mutation(0, key, new)]))
                    except mp.NotCommittedError:
                        counts["conflicts"] += 1
                        continue
                    commit_s.append(time.perf_counter() - t3)
                    committed.append((v, key, new))
                    updates[rid] += 1
                    counts["updates"] += 1
                    break
                else:
                    counts["gave_up"] += 1

        t0 = time.perf_counter()
        killed = None
        if kill_storage:
            half = ops // 2
            await asyncio.gather(*(client(c, 0, half)
                                   for c in range(clients)))
            run_s = time.perf_counter() - t0
            killed = await kill_restart()
            t0 = time.perf_counter()
            await asyncio.gather(*(client(c, half, ops)
                                   for c in range(clients)))
            run_s += time.perf_counter() - t0
        else:
            await asyncio.gather(*(client(c) for c in range(clients)))
            run_s = time.perf_counter() - t0
        await pipe.stop()
        storage = conns["storage"]
        if pipe.failed is not None:
            fail(f"{label}: the pipeline failed: {pipe.failed!r}")
        head = pipe.committed_version
        st1 = {n: await status(n) for n in COMMIT_CHILDREN}
        if mp._tls_from_env() is not None:
            # every child speaks mutual TLS: a plaintext client is refused
            bare = transport.RpcConnection(procs["storage"].address)
            try:
                await bare.connect(retries=1, delay=0.01)
            except transport.TransportError:
                out["tls_plaintext_refused"] = True
            else:
                fail(f"{label}: the storage child served a plaintext client")
            finally:
                await bare.close()
        snap = await storage.call(mp.TOKEN_STORAGE_SNAPSHOT,
                                  mp.StorageSnapshotReq(version=head),
                                  timeout=300.0)
        peek = await tlog.call(mp.TOKEN_TLOG_PEEK_BATCH,
                               mp.TLogPeekBatchReq(after_version=-1,
                                                   max_entries=1 << 31),
                               timeout=300.0)
        for c in (res, tlog, storage, *plain.values()):
            await c.close()
        batches = len(res.calls) - load_batches
        attempts = counts["updates"] + counts["conflicts"]
        p50, p99 = quantiles_ms(commit_s)
        out["workload"] = dict(
            seconds=run_s, reads=counts["reads"],
            committed=counts["updates"], conflicted=counts["conflicts"],
            gave_up=counts["gave_up"],
            abort_share=counts["conflicts"] / max(1, attempts),
            commits_per_s=counts["updates"] / run_s,
            commit_p50_ms=p50, commit_p99_ms=p99,
            grv_p50_ms=statistics.median(grv_s) * 1e3,
            read_p50_ms=statistics.median(read_s) * 1e3,
            batches=batches,
            mean_batch_txns=attempts / max(1, batches))
        out["children"] = {n: dict(spawn_to_first_answer_s=started[n])
                           for n in COMMIT_CHILDREN}
        out["resolver_status"] = (st0, st1["resolver"])
        out["tlog_status"] = st1["tlog"]["qos"]
        out["storage_status"] = {k: st1["storage"]["qos"][k]
                                 for k in ("applies", "keys",
                                           "apply_batch_mutations")}
        if encrypt:
            # the storage's seal and open counts, both of its processes
            out["sealing"] = dict(
                tlog=st1["tlog"]["encryption"],
                storage=[b["encryption"] for b in (
                    (killed["before"], st1["storage"]) if killed
                    else (st1["storage"],))])
        return (head, res.calls, tlog.calls, committed, updates, snap, peek,
                killed)

    try:
        (head, resolves, log_calls, committed, updates, snap, peek,
         killed) = asyncio.run(drive())
        if encrypt:
            for p in procs.values():
                p.stop()
            out["at_rest"] = sealed_disk_checks(
                label, data_dirs, [values[i] for i in np.random.default_rng(
                    seed).choice(records, SE_SAMPLES, replace=False)])
    finally:
        for p in procs.values():
            p.stop()
        shutil.rmtree(work, ignore_errors=True)

    # 1. every resolver reply against the copied oracle, in version order
    t0 = time.perf_counter()
    prev = replay_against_oracle(
        [(req, packing.columnar_to_transactions(req.cols), rep)
         for _tok, req, rep in resolves], ROLE_WINDOW, label)
    if prev != head:
        fail(f"{label}: the last resolved version {prev} is not the "
             f"committed head {head}")
    oracle_s = time.perf_counter() - t0

    # 2. the storage snapshot at the head is the replay of the commits
    want_kv: dict = {}
    by_version: dict = {}
    for v, k, val in sorted(committed, key=lambda c: c[0]):
        want_kv[k] = val
        by_version.setdefault(v, []).append((0, k, val))
    if snap.version < head or snap.kvs != sorted(want_kv.items()):
        fail(f"{label}: the storage snapshot at {head} ({len(snap.kvs)} "
             f"keys) is not the replay of {len(committed)} commits")
    if killed is not None:
        killed_checks(label, killed, encrypt, out)
    # 3. the exact count
    for rid, n in enumerate(updates):
        if int.from_bytes(want_kv[keys[rid]][:8], "little") != n:
            fail(f"{label}: record {rid}'s counter is not its {n} "
                 "committed updates")
    # 4. the tlog: a push a batch, of exactly its committed mutations; its
    # entries the pushes past the last pop
    pushes = [m for tok, m, _r in log_calls if tok == mp.TOKEN_TLOG_PUSH]
    pops = [(m.version, r is not None) for tok, m, r in log_calls
            if tok == mp.TOKEN_TLOG_POP]
    if [p.version for p in pushes] != sorted(r[1].version for r in resolves):
        fail(f"{label}: the tlog pushes are not one a resolved batch")
    for p in pushes:
        got = sorted((m.op, m.param1, m.param2) for m in p.mutations)
        if got != sorted(by_version.get(p.version, [])):
            fail(f"{label}: the push at {p.version} is not its batch's "
                 "committed mutations")
    # the pushes past the last acknowledged pop, less those a pop sent
    # but not yet answered at the pipeline's stop may have taken
    acked = max((v for v, ok in pops if ok), default=-1)
    sent = max((v for v, _ok in pops), default=-1)
    pushed = [(p.version, [(m.op, m.param1, m.param2) for m in p.mutations])
              for p in pushes]
    peeked = [(v, [(m.op, m.param1, m.param2) for m in g])
              for v, g in zip(peek.versions, peek.groups)]
    gone = pushed[:len(pushed) - len(peeked)]
    if (peeked != pushed[len(gone):] or any(v <= acked for v, _ in peeked)
            or any(v > sent for v, _ in gone)):
        fail(f"{label}: the tlog holds {len(peeked)} entries, not the "
             f"pushes past its last pop ({acked} answered, {sent} sent)")
    out.update(head=head, oracle_replay_s=oracle_s, pops=len(pops),
               tlog_entries_at_end=len(peeked),
               snapshot_keys=len(snap.kvs))
    w = out["workload"]
    log(f"  workload A: {w['committed']} updates committed, "
        f"{w['conflicted']} conflicted (abort share "
        f"{w['abort_share']:.4f}, {w['gave_up']} gave up after "
        f"{COMMIT_RETRIES} retries), {w['reads']} reads in "
        f"{w['seconds']:.3f} s: {w['commits_per_s']:.1f} commits/s; "
        f"commit p50 {w['commit_p50_ms']:.3f} ms, p99 "
        f"{w['commit_p99_ms']:.3f} ms; GRV p50 {w['grv_p50_ms']:.4f} ms, "
        f"read p50 {w['read_p50_ms']:.3f} ms; {w['batches']} batches, mean "
        f"{w['mean_batch_txns']:.1f} txns; on {card}")
    log("  children up (spawn to first answer, s): "
        + ", ".join(f"{n} {out['children'][n]['spawn_to_first_answer_s']:.2f}"
                    for n in COMMIT_CHILDREN) + f"; on {card}")
    log(f"  checks: {len(resolves)} resolver replies identical to "
        f"ConflictOracle (replayed in {oracle_s:.1f} s), the storage "
        f"snapshot at {head} ({len(snap.kvs)} keys) the replay of "
        f"{len(committed)} commits, every counter its committed updates, "
        f"{len(pushes)} tlog pushes their batches' mutations, "
        f"{len(peeked)} entries left past {len(pops)} pops, no failed batch")
    return out


def replay_against_oracle(resolves, window: int, label: str) -> int:
    """Replay one resolver's (request, transactions, reply) triples on a
    fresh copied ConflictOracle in version order from the chain's start
    (prev_version -1): fail unless each request chains to the one before
    it and each reply's verdicts and conflict reports are the oracle's.
    Returns the last replayed version (-1 for none)."""
    from foundationdb_tpu_torch.testing.oracle import (
        ConflictOracle,
        OracleTxn,
    )

    oracle = ConflictOracle(window=window)
    prev = -1
    for req, txns, rep in sorted(resolves, key=lambda r: r[0].version):
        if req.prev_version != prev:
            fail(f"{label}: request {req.version} chains to "
                 f"{req.prev_version}, not {prev}")
        want = oracle.resolve([OracleTxn(t.read_conflict_ranges,
                                         t.write_conflict_ranges,
                                         t.read_snapshot,
                                         t.report_conflicting_keys)
                               for t in txns], req.version)
        if [int(x) for x in rep.committed] != list(want.verdicts):
            fail(f"{label}: batch {req.version}: verdicts differ from "
                 "ConflictOracle")
        if rep.conflicting_key_range_map != want.conflicting_ranges:
            fail(f"{label}: batch {req.version}: conflict reports differ "
                 "from ConflictOracle")
        prev = req.version
    return prev


def tiered_launch_want(uniform: dict, batches: int, compactions: int) -> dict:
    """The launches the tiered path makes in `batches` resolved batches
    with `compactions` compactions: each kernel of TIERED_PER_BATCH phase
    3's count a batch (the same tiered path at bench shapes), merge_maps
    one a batch and one more a compaction, held first against phase 3's
    own merge_maps count."""
    n3 = uniform["batches"]
    if uniform["launches"]["merge_maps"] != n3 + n3 // COMPACT_INTERVAL:
        fail(f"phase 3 launched merge_maps {uniform['launches']['merge_maps']}"
             f" times in {n3} batches")
    want = {"merge_maps": batches + compactions}
    for k in TIERED_PER_BATCH:
        per, rest = divmod(uniform["launches"][k], n3)
        if rest or not per:
            fail(f"phase 3 launched {k} {uniform['launches'][k]} times in "
                 f"{n3} batches")
        want[k] = per * batches
    return want


def check_commit_launches(out: dict, uniform: dict, card: str,
                          label: str = "commit path") -> None:
    """The resolver child launched the card's kernels, each the count
    tiered_launch_want gives for the child's resolved batches and
    compactions. Phase 8's counts are the classic path's: the tiered one
    probes its two tiers and merges at each compaction."""
    st0, st1 = out.pop("resolver_status")
    a, b = st1["kernel_launches"], st0["kernel_launches"]
    launches = {k: a[k] - b[k] for k in a if a[k] != b[k]}
    batches = st1["qos"]["kernel"]["batches"] - st0["qos"]["kernel"]["batches"]
    compactions = (st1["qos"]["kernel_stages"]["compactions"]
                   - st0["qos"]["kernel_stages"]["compactions"])
    if not launches or batches <= 0:
        fail(f"{label}: the resolver child launched {launches} in "
             f"{batches} batches")
    for k, n in tiered_launch_want(uniform, batches, compactions).items():
        if launches.get(k, 0) != n:
            fail(f"{label}: the resolver child launched {k} "
                 f"{launches.get(k, 0)} times in {batches} batches "
                 f"({compactions} compactions), not {n}")
    q = st1["qos"]
    out["resolver"] = dict(
        batches=batches, compactions=compactions, launches=launches,
        launches_per_batch={k: n / batches for k, n in launches.items()},
        compute_p50_ms=q["compute_time_dist"]["p50"] * 1e3,
        compute_p99_ms=q["compute_time_dist"]["p99"] * 1e3,
        resolve_path=q["resolve_path"])
    log(f"  resolver child: {batches} batches ({compactions} compactions), "
        f"compute p50 {out['resolver']['compute_p50_ms']:.3f} ms, p99 "
        f"{out['resolver']['compute_p99_ms']:.3f} ms; kernel launches a "
        f"batch {json.dumps(out['resolver']['launches_per_batch'])}; on "
        f"{card}")


# ---------------------------------------------------------------------------
# phase 16: the simulated cluster

#: the phase's wall budget (load and workload of the full run)
SIM_BUDGET_S = 150.0
#: the share of the budget the load may take: the records are cut to what
#: part (a)'s measured load rate does in it
SIM_LOAD_SHARE = 0.4
#: part (a): one short seed, on the card and on the host oracle
SIM_TWIN = dict(records=5_000, clients=64, ops=10)
#: YCSB loader threads: each inserts its share of the records in turn. The
#: GRV front door sheds past GRV_PROXY_MAX_QUEUE = 8,192 waiting requests,
#: so the load is not offered all at once as phase 15 does. A loader has
#: at most one GRV request waiting, so 4,096 loaders, half that limit,
#: stay well under it
SIM_LOADERS = 4_096
#: virtual seconds a storage server may take to apply the last commit
SIM_CATCH_UP = 5.0


def sim_cluster_config(records: int, backend: str, device, cfg):
    """bench_pipeline --mode cluster's deployment in FoundationDB's
    `double` redundancy: two commit proxies, two resolvers, four storage
    servers in teams of two, two log replicas. The resolver boundary sits
    at the middle of the records' keys and the storage boundaries at
    their quartiles (the even one-byte split would put every b"user..."
    key on one resolver and one team), as the resolution balancer and
    data distribution would move them."""
    from foundationdb_tpu_torch.cluster.database import ClusterConfig

    return ClusterConfig(
        n_commit_proxies=2, n_resolvers=2, n_storage=4, replication_factor=2,
        n_tlogs=2, resolver_backend=backend, device=device, kernel_config=cfg,
        resolver_boundaries=[b"user%010d" % (records // 2)],
        storage_boundaries=[b"user%010d" % (records * q // 4)
                            for q in (1, 2, 3)])


def sim_cluster_run(inputs: dict, *, records: int, clients: int, ops: int,
                    backend: str, device, cfg) -> dict:
    """One run of the simulated cluster: `open_cluster`'s Cluster on a
    Scheduler(sim=True), YCSB's load (one insert a `Database`
    transaction through `Database.run`, from SIM_LOADERS loader tasks)
    and workload A (a task a client; a read is a transaction's get, an
    update a read-modify-write of the counter field committed with its
    read, retried on NotCommitted up to COMMIT_RETRIES times), until
    every storage server has applied the last commit. Returns the outcomes, the cluster, its scheduler and the
    resolvers' recorded (request, reply) pairs, with the walls; the
    caller stops the cluster."""
    from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted
    from foundationdb_tpu_torch.cluster.database import Cluster
    from foundationdb_tpu_torch.runtime import census
    from foundationdb_tpu_torch.runtime.flow import Scheduler, all_of

    keys, values = inputs["keys"], inputs["values"]
    sched = Scheduler(sim=True)
    census0 = census.snapshot(sched)
    t0 = time.perf_counter()
    # open_cluster's steps, with the resolvers recorded before the start
    # runs the bootstrap batch, so every batch a resolver takes is replayed
    cluster = Cluster(sched, sim_cluster_config(records, backend, device,
                                                cfg))
    calls = {r.resolver_id: [] for r in cluster.resolvers}
    #: wall seconds of each conflict-set resolve() call, per resolver
    computes = {r.resolver_id: [] for r in cluster.resolvers}
    inside = {"s": 0.0}
    for r in cluster.resolvers:
        async def recorded(req, _resolve=r.resolve, _log=calls[r.resolver_id]):
            rep = await _resolve(req)
            _log.append((req, rep))
            return rep

        def timed(txns, version, _resolve=r.conflict_set.resolve,
                  _times=computes[r.resolver_id]):
            t = time.perf_counter()
            try:
                return _resolve(txns, version)
            finally:
                _times.append(time.perf_counter() - t)
                inside["s"] += _times[-1]

        r.resolve = recorded
        r.conflict_set.resolve = timed
    cluster.start()
    db = cluster.database()
    boot_s = time.perf_counter() - t0
    outcomes, reads, committed = [], [], []
    updates = [0] * records

    async def loader(share):
        # a YCSB loader thread: its share of the inserts one after the
        # other, each through the client's retry loop
        for i in share:
            attempts = []

            async def write(txn, i=i):
                attempts.append(txn)
                txn.set(keys[i], values[i])

            await db.run(write)
            committed.append((attempts[-1].committed_version, keys[i],
                              values[i]))

    def phase(coros):
        tasks = [sched.spawn(c, name=f"ycsb{n}") for n, c in enumerate(coros)]
        w0, v0, in0 = time.perf_counter(), sched.now(), inside["s"]
        sched.run_until(all_of([t.done for t in tasks]))
        return (time.perf_counter() - w0, sched.now() - v0,
                inside["s"] - in0)

    order = inputs["insert_order"]
    load = phase(loader(order[n::SIM_LOADERS]) for n in range(SIM_LOADERS))
    counts = dict(reads=0, updates=0, conflicts=0, gave_up=0)

    async def client(c):
        for j in range(ops):
            rid = inputs["record"][c][j]
            key = keys[rid]
            for _attempt in range(1 + COMMIT_RETRIES):
                txn = db.create_transaction()
                cur = await txn.get(key)
                reads.append(cur)
                if cur is None or len(cur) != len(values[rid]):
                    fail(f"sim cluster: record {rid} read {cur!r:.40}")
                if inputs["is_read"][c][j]:
                    counts["reads"] += 1
                    outcomes.append((c, j, "read"))
                    break
                f = inputs["field"][c][j] * COMMIT_FIELD_BYTES
                new = ((int.from_bytes(cur[:8], "little") + 1)
                       .to_bytes(8, "little") + cur[8:f]
                       + inputs["new_field"][c, j].tobytes()
                       + cur[f + COMMIT_FIELD_BYTES:])
                txn.set(key, new)
                try:
                    await txn.commit()
                except NotCommitted as e:
                    counts["conflicts"] += 1
                    outcomes.append((c, j, type(e).__name__))
                    continue
                outcomes.append((c, j, txn.committed_version))
                committed.append((txn.committed_version, key, new))
                updates[rid] += 1
                counts["updates"] += 1
                break
            else:
                counts["gave_up"] += 1

    work = phase(client(c) for c in range(clients))
    head = max(v for v, _k, _val in committed)

    async def caught_up():
        t_end = sched.now() + SIM_CATCH_UP
        while any(ss.version.get() < head for ss in cluster.storage_servers):
            if sched.now() > t_end:
                fail(f"sim cluster: storage versions "
                     f"{[ss.version.get() for ss in cluster.storage_servers]}"
                     f" short of the last commit {head}")
            await sched.delay(0.01)

    sched.run_until(sched.spawn(caught_up(), name="catch-up").done)
    return dict(sched=sched, cluster=cluster, census0=census0, calls=calls,
                computes=computes,
                outcomes=outcomes, reads=reads, committed=committed,
                updates=updates, counts=counts, head=head, boot_s=boot_s,
                load=load, work=work)


def sim_cluster_stop(run: dict) -> None:
    """Stop the cluster and drain the cancellations: no actor error left
    unhandled, and the census (live tasks, connections, servers) back to
    its reading before boot; the process's file descriptors are left out
    (the card's runtime opens its own as it goes)."""
    from foundationdb_tpu_torch.runtime import census

    sched = run["sched"]
    run["cluster"].stop()
    sched.run_for(1.0)
    bad = [(n, repr(e)) for n, e in sched.unhandled_errors()]
    if bad:
        fail(f"sim cluster: after stop, unhandled actor errors {bad[:5]}")
    leaks = census.growth(run["census0"], census.snapshot(sched),
                          ignore={"fds"})
    if leaks:
        fail(f"sim cluster: after stop, {'; '.join(leaks)}")


def sim_digest(run: dict) -> dict:
    """What part (a) compares: each transaction's outcome, every read,
    each storage server's snapshot, each log replica's durable records
    and the final virtual time."""
    cluster = run["cluster"]
    return dict(
        outcomes=run["outcomes"], reads=run["reads"],
        committed=sorted(run["committed"]),
        storage=[ss.snapshot() for ss in cluster.storage_servers],
        logs=[[(r.seq, r.is_pop, r.pop_to, r.data) for r in t.dq._disk]
              for t in cluster.tlog.tlogs],
        now=run["sched"].now())


def sim_cluster_checks(run: dict, window: int) -> dict:
    """Part (b)'s checks on a finished run (before its stop): every
    resolver's replies, the bootstrap's included, against the copied
    ConflictOracle on its own requests replayed in version order from
    the chain's start to its last resolved version, check_cluster, every record on
    both replicas of its team equal to the replay of the committed
    mutations, each counter its committed updates."""
    from foundationdb_tpu_torch.cluster.consistency import check_cluster

    cluster = run["cluster"]
    t0 = time.perf_counter()
    replies = 0
    for r in cluster.resolvers:
        log_ = run["calls"][r.resolver_id]
        last = replay_against_oracle(
            [(req, req.transactions, rep) for req, rep in log_], window,
            f"sim cluster: resolver {r.resolver_id}")
        if last != r.version.get():
            fail(f"sim cluster: resolver {r.resolver_id}'s last replayed "
                 f"version {last} is not its last resolved "
                 f"{r.version.get()}")
        replies += len(log_)
    oracle_s = time.perf_counter() - t0
    stats = check_cluster(cluster)
    want_kv: dict = {}
    for _v, k, val in sorted(run["committed"], key=lambda c: c[0]):
        want_kv[k] = val
    if not all(cluster.storage_live):
        fail(f"sim cluster: storage liveness {cluster.storage_live}")
    copies = 0
    # `_data` materializes a server's latest values: once a server
    data = [ss._data for ss in cluster.storage_servers]
    for k, val in want_kv.items():
        for s in cluster.key_servers.team_of(k):
            if data[s].get(k) != val:
                fail(f"sim cluster: storage{s} does not hold the committed "
                     f"value of {k!r}")
            copies += 1
    for rid, n in enumerate(run["updates"]):
        k = b"user%010d" % rid
        if int.from_bytes(want_kv[k][:8], "little") != n:
            fail(f"sim cluster: record {rid}'s counter is not its {n} "
                 "committed updates")
    return dict(replies=replies, oracle_replay_s=oracle_s,
                replica_copies=copies, keys=len(want_kv), **stats)


def sim_numbers(run: dict, card: str) -> dict:
    """The walls, rates, abort share, resolver compute and batch sizes of
    a run, printed beside the card's name and power limit."""
    c = run["counts"]
    attempts = c["updates"] + c["conflicts"]
    resolvers = run["cluster"].resolvers
    batches = sum(r.conflict_set.metrics.counters.get("resolveBatches")
                  for r in resolvers)
    txns = sum(r.counters.get("resolvedTransactions") for r in resolvers)
    out = dict(
        load=dict(records=len(run["committed"]) - c["updates"],
                  wall_s=run["load"][0], virtual_s=run["load"][1],
                  commits_per_wall_s=(len(run["committed"]) - c["updates"])
                  / run["load"][0],
                  commits_per_virtual_s=(len(run["committed"]) - c["updates"])
                  / run["load"][1]),
        workload=dict(wall_s=run["work"][0], virtual_s=run["work"][1],
                      committed=c["updates"], conflicted=c["conflicts"],
                      gave_up=c["gave_up"], reads=c["reads"],
                      abort_share=c["conflicts"] / max(1, attempts),
                      commits_per_wall_s=c["updates"] / run["work"][0],
                      commits_per_virtual_s=c["updates"] / run["work"][1]),
        boot_s=run["boot_s"],
        resolve_share_of_wall=(run["load"][2] + run["work"][2])
        / (run["load"][0] + run["work"][0]),
        resolve_share=dict(load=run["load"][2] / run["load"][0],
                           workload=run["work"][2] / run["work"][0]),
        batches=batches, mean_batch_txns=txns / max(1, batches),
        compute_p50_ms=[quantiles_ms(t)[0]
                        for _r, t in sorted(run["computes"].items())],
        compute_p99_ms=[quantiles_ms(t)[1]
                        for _r, t in sorted(run["computes"].items())],
        kernel_stage_p50_ms={
            f"resolver{r.resolver_id}": {
                st: getattr(r.conflict_set.metrics, st).as_dict()["p50"] * 1e3
                for st in ("pack", "kernel", "fence")}
            for r in resolvers})
    ld, wk = out["load"], out["workload"]
    log(f"  load: {ld['records']} inserts in {ld['wall_s']:.3f} s wall, "
        f"{ld['virtual_s']:.4f} s virtual ({ld['commits_per_wall_s']:.1f} "
        f"commits/s wall, {ld['commits_per_virtual_s']:.1f} virtual) on "
        f"{card}")
    log(f"  workload A: {wk['committed']} updates committed, "
        f"{wk['conflicted']} conflicted (abort share "
        f"{wk['abort_share']:.4f}, {wk['gave_up']} gave up), {wk['reads']} "
        f"reads in {wk['wall_s']:.3f} s wall, {wk['virtual_s']:.4f} s "
        f"virtual: {wk['commits_per_wall_s']:.1f} commits/s wall, "
        f"{wk['commits_per_virtual_s']:.1f} virtual; on {card}")
    log(f"  resolvers: {batches} batches (both), mean "
        f"{out['mean_batch_txns']:.1f} txns; compute p50 "
        f"{[round(x, 3) for x in out['compute_p50_ms']]} ms, p99 "
        f"{[round(x, 3) for x in out['compute_p99_ms']]} ms; inside the "
        f"conflict sets' resolve() {out['resolve_share_of_wall']:.4f} of "
        f"the wall (load {out['resolve_share']['load']:.4f}, workload "
        f"{out['resolve_share']['workload']:.4f}); on {card}")
    return out


def phase_sim_cluster(card: str, uniform: dict, *, cfg=None, device=None,
                      seed: int = 16) -> dict:
    """The port's simulated cluster on the card (cell SC): part (a), one
    short seed run twice in this process, resolvers "cuda" on the card
    and "cpu" (the host oracle), identical outcomes, reads, storage
    snapshots, log records and virtual time; part (b), phase 15's
    traffic through `open_cluster` with both resolvers' tiers on the
    card, every check of `sim_cluster_checks`, the launch rule and a
    clean stop. The records are cut to what part (a)'s load rate does in
    SIM_LOAD_SHARE of SIM_BUDGET_S."""
    from foundationdb_tpu_torch import kernels

    cfg = cfg or commit_config()
    tw = SIM_TWIN
    inputs = ycsb_a_inputs(seed, tw["records"], tw["clients"], tw["ops"])
    twins = {}
    for backend in ("cuda", "cpu"):
        run = sim_cluster_run(inputs, **tw, backend=backend, device=device,
                              cfg=cfg)
        twins[backend] = (sim_digest(run), run["load"][0]
                          / tw["records"])
        sim_cluster_stop(run)
    (dig_c, per_insert), (dig_h, _) = twins["cuda"], twins["cpu"]
    for k in dig_c:
        if dig_c[k] != dig_h[k]:
            fail(f"sim cluster twin: the card's and the host oracle's runs "
                 f"differ in {k}")
    log(f"  (a) twin: {tw['records']} records, {tw['clients']} clients x "
        f"{tw['ops']} ops: the card's and the host oracle's runs identical "
        f"({len(dig_c['outcomes'])} outcomes, {len(dig_c['reads'])} reads, "
        f"{len(dig_c['storage'])} storage snapshots, "
        f"{sum(map(len, dig_c['logs']))} log records, virtual time "
        f"{dig_c['now']:.6f} s); the card's load {per_insert * 1e3:.3f} ms "
        f"an insert on {card}")
    records = min(COMMIT_RECORDS, max(
        tw["records"],
        int(SIM_LOAD_SHARE * SIM_BUDGET_S / per_insert) // 1000 * 1000))
    log(f"  (b) cut: {records} records of {COMMIT_FIELDS} x "
        f"{COMMIT_FIELD_BYTES} bytes (phase 15 loads {COMMIT_RECORDS}; "
        f"SIM_LOAD_SHARE {SIM_LOAD_SHARE} of the {SIM_BUDGET_S:.0f} s budget"
        f" at (a)'s rate); {COMMIT_CLIENTS} clients x {COMMIT_OPS} "
        f"operations of workload A; kernel_config={cfg!r}")
    inputs = ycsb_a_inputs(seed, records, COMMIT_CLIENTS, COMMIT_OPS)
    kernels.reset_counts()
    t0 = time.perf_counter()
    run = sim_cluster_run(inputs, records=records, clients=COMMIT_CLIENTS,
                          ops=COMMIT_OPS, backend="cuda", device=device,
                          cfg=cfg)
    wall_s = time.perf_counter() - t0
    launches = kernels.counts()
    resolvers = run["cluster"].resolvers
    on = "cuda" if device is None else str(device)
    for r in resolvers:
        cs = r.conflict_set
        if type(cs).__name__ != "TorchConflictSet" or cs.device.type != on:
            fail(f"sim cluster: resolver {r.resolver_id} resolves on "
                 f"{type(cs).__name__} ({getattr(cs, 'device', None)})")
    out = dict(records=records, clients=COMMIT_CLIENTS, ops=COMMIT_OPS,
               card=card, phase_wall_s=wall_s,
               checks=sim_cluster_checks(run, cfg.window_versions))
    out.update(sim_numbers(run, card))
    batches = sum(r.conflict_set.metrics.counters.get("resolveBatches")
                  for r in resolvers)
    compactions = sum(r.conflict_set.metrics.counters.get("compactions")
                      for r in resolvers)
    empty = sum(1 for calls in run["calls"].values() for req, _ in calls
                if not req.transactions)
    sim_cluster_stop(run)
    for k, n in tiered_launch_want(uniform, batches, compactions).items():
        if launches.get(k, 0) != n:
            fail(f"sim cluster: {k} launched {launches.get(k, 0)} times in "
                 f"{batches} batches ({compactions} compactions, {empty} "
                 f"empty), not {n}")
    out["resolver"] = dict(
        batches=batches, compactions=compactions, empty_batches=empty,
        launches={k: n for k, n in launches.items() if n},
        launches_per_batch={k: n / batches for k, n in launches.items()
                            if n})
    c = out["checks"]
    log(f"  checks: both resolvers TorchConflictSets on the card, "
        f"{c['replies']} replies identical to ConflictOracle (replayed in "
        f"{c['oracle_replay_s']:.1f} s), check_cluster "
        f"({c['replica_compares']} replica compares), {c['keys']} keys on "
        f"both replicas ({c['replica_copies']} copies) the replay of the "
        f"commits, every counter its committed updates; {batches} batches "
        f"({empty} empty, dispatched like any other: phase 3's launches a "
        f"batch; {compactions} compactions) launched "
        f"{json.dumps(out['resolver']['launches_per_batch'])} a batch; no "
        f"actor error or live task left; phase wall {wall_s:.1f} s of the "
        f"{SIM_BUDGET_S:.0f} s budget; on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the wire cluster under its controller

#: the phase's wall budget, from the monitor's start to its teardown
LC_BUDGET_S = 240.0
#: the workers the monitor starts: the topology's nine roles and a spare
LC_WORKERS = 10
LC_ROLES = 9
#: seconds a ClusterClient waits for a recovered generation (each
#: recruit builds a resolver on the card, one after the other)
LC_RECOVERY_TIMEOUT = 180.0
#: the storage engine: the versioned LSM (native/vlsm.cpp), whose
#: checkpoint flushes the memtable; the memory engine's serializes the
#: whole store every 8 applied versions, and two proxies' small batches
#: make that thousands of 100 MB checkpoints
LC_STORAGE_ENGINE = "lsm"
#: records read back through the front door at the end (the storage
#: role's snapshot holds every one)
LC_READ_BACK = 1_000
#: a key no transaction of the workload writes: a read of it at a
#: snapshot from before the kill aborts only through the recovery's
#: conservative write
LC_STALE_KEY = b"lc/stale-snapshot-probe"
#: the in-flight set of tests/test_lifecycle.py:218-283 and the
#: decisions the sim recovery makes on it
LC_INFLIGHT_DECISIONS = ["abort", "commit", "abort", "commit", "commit",
                         "abort"]
LC_PARITY_KERNEL = ("KernelConfig(max_key_bytes=16, max_txns=64, "
                    "max_reads=256, max_writes=256, history_capacity=65536, "
                    "window_versions=5000000)")


def lc_conf(work: str, cfg, device) -> str:
    """The deployment: the controller's declarative topology at
    scripts/bench_pipeline.py's two proxies and two resolvers (2 tlogs, 1
    storage, the sequencer, 2 resolvers on the card at `cfg`, a
    ratekeeper, 2 proxies: 9 roles) in cluster.json, and the monitor's
    conf starting the controller and LC_WORKERS workers, as fdbmonitor
    would. The proxies batch as phase 15's pipeline does (max_batch the
    kernel's batch, 1 ms). Returns the monitor conf's path."""
    conf = {"tlogs": 2, "resolvers": 2, "proxies": 2, "ratekeeper": True,
            "backend": "cuda", "resolver_kernel": repr(cfg),
            "tlog_data_dir": os.path.join(work, "tlog-data"),
            "storage_data_dir": os.path.join(work, "storage-data"),
            "storage_engine": LC_STORAGE_ENGINE,
            "max_batch": cfg.max_txns,
            "batch_interval": COMMIT_BATCH_INTERVAL}
    if device is not None:
        conf["device"] = str(device)
    with open(os.path.join(work, "cluster.json"), "w") as f:
        json.dump(conf, f)
    ctrl = os.path.join(work, "controller0.sock")
    lines = ["[role.controller]", "kind = controller",
             f"socket_dir = {work}",
             f"cluster_conf = {os.path.join(work, 'cluster.json')}",
             f"state_file = {os.path.join(work, 'controller-state.json')}",
             ""]
    for i in range(LC_WORKERS):
        lines += [f"[role.w{i}]", "kind = worker", f"socket_dir = {work}",
                  f"index = {i}", f"controller = {ctrl}"]
        if device is not None:
            lines.append(f"device = {device}")
        lines.append("")
    path = os.path.join(work, "monitor.conf")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def launched_pids(lines: list) -> list:
    """The pid of every process the monitor started, from its log's
    "[monitor] launched <name> (<kind>) pid=N" lines."""
    return [int(ln.rsplit("pid=", 1)[1]) for ln in lines
            if ln.startswith("[monitor] launched ") and "pid=" in ln]


def running(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:  # gone, or the pid is another user's by now
        return False
    return True


def missed_conflicts(txns: list) -> list:
    """The committed transactions that read a key another committed
    transaction wrote at a version in (their read snapshot, their commit
    version]. `txns` holds (read snapshot, commit version, read keys,
    written keys) of every committed transaction."""
    import bisect

    writes: dict = {}
    for _rs, cv, _r, ws in txns:
        for k in ws:
            writes.setdefault(k, []).append(cv)
    for vs in writes.values():
        vs.sort()
    bad = []
    for rs, cv, reads, ws in txns:
        for k in reads:
            vs = writes.get(k, [])
            n = bisect.bisect_right(vs, cv) - bisect.bisect_right(vs, rs)
            if n - (k in ws) > 0:
                bad.append((rs, cv, k))
    return bad


def unexplained_aborts(aborts: list, txns: list, unknowns: list,
                       recoveries: list, window: int) -> list:
    """The aborted transactions that nothing explains. `aborts` holds
    (key, read snapshot, reason, a read version taken after the reply)
    of every NotCommittedError. The reply fires only after its batch's
    version is reported committed, so that read version bounds the
    batch's. A CONFLICT needs, in (its snapshot, that bound], a write to
    its key by a committed transaction (`txns`, as missed_conflicts
    takes them), a write whose outcome is unknown (`unknowns`: (key, its
    read snapshot); if it committed, its version lies above that
    snapshot) or a generation's recovery version at or above the
    snapshot (its conservative transaction writes every key at a version
    above it). A TOO_OLD needs its
    snapshot more than `window` versions below the bound."""
    import bisect

    writes: dict = {}
    for _rs, cv, _r, ws in txns:
        for k in ws:
            writes.setdefault(k, []).append(cv)
    for vs in writes.values():
        vs.sort()
    maybe: dict = {}
    for k, rs in unknowns:
        maybe[k] = min(rs, maybe.get(k, rs))
    bad = []
    for k, rs, reason, bound in aborts:
        if reason == "TOO_OLD":
            ok = rs < bound - window
        else:
            vs = writes.get(k, [])
            ok = (bisect.bisect_right(vs, bound) > bisect.bisect_right(vs, rs)
                  or maybe.get(k, bound) < bound
                  or any(rs <= r < bound for r in recoveries))
        if not ok:
            bad.append((k, rs, reason, bound))
    return bad


def sim_recovery_decisions() -> list:
    """The port's own sim recovery (cluster/recovery.py through
    open_cluster, the host oracle) on the in-flight set of
    tests/test_lifecycle.py: a commit, a snapshot, the proxy failed, the
    new generation's decisions on the set."""
    from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted
    from foundationdb_tpu_torch.cluster.database import (
        ClusterConfig,
        open_cluster,
    )

    sched, cluster, db = open_cluster(ClusterConfig(
        n_commit_proxies=1, n_resolvers=1, n_storage=1,
        resolver_backend="cpu"))
    out = {}
    try:
        async def body():
            txn = db.create_transaction()
            txn.set(b"seed", b"s")
            await txn.commit()
            stale = await db.create_transaction().get_read_version()
            p = cluster.commit_proxies[0]
            p.failed = RuntimeError("chaos")
            p.stop()
            await sched.delay(1.0)
            if cluster.controller.epoch != 2:
                fail(f"sim recovery: epoch {cluster.controller.epoch}")
            fresh = await db.create_transaction().get_read_version()
            decisions = []
            for t in inflight_set(stale, fresh):
                try:
                    await cluster.commit_proxies[0].commit(t).future
                    decisions.append("commit")
                except NotCommitted:
                    decisions.append("abort")
            out["decisions"] = decisions

        sched.run_until(sched.spawn(body()).done)
    finally:
        cluster.stop()
    return out["decisions"]


def inflight_set(stale_rv: int, fresh_rv: int) -> list:
    """tests/test_lifecycle.py's in-flight mix around a recovery: stale
    readers (abort), stale blind writes (commit), fresh readers
    (commit)."""
    from foundationdb_tpu_torch.models.types import CommitTransaction

    def kr(k):
        return [(k, k + b"\x00")]

    def mk(rs, ws, snap):
        return CommitTransaction(read_conflict_ranges=rs,
                                 write_conflict_ranges=ws, read_snapshot=snap)

    return [mk(kr(b"a"), kr(b"a"), stale_rv), mk([], kr(b"b"), stale_rv),
            mk(kr(b"c"), [], stale_rv), mk(kr(b"d"), kr(b"d"), fresh_rv),
            mk([], kr(b"e"), fresh_rv),
            mk(kr(b"\xfe"), kr(b"\xfe"), stale_rv)]


def recovery_parity_on_card(device) -> dict:
    """Check 5: a ResolverRole(backend="cuda", epoch=2) in this process
    at tests/test_lifecycle.py's small RESOLVER_KERNEL, fresh as a
    recruit is, takes the controller's boot batch, the conservative
    recovery transaction and then the in-flight set, and decides it as
    the sim recovery does."""
    import asyncio

    from foundationdb_tpu_torch.cluster import generation as gen
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.models.types import (
        ResolveTransactionBatchRequest,
        TransactionResult,
    )

    sim = sim_recovery_decisions()
    old = os.environ.get("RESOLVER_KERNEL")
    os.environ["RESOLVER_KERNEL"] = LC_PARITY_KERNEL
    try:
        role = mp.ResolverRole(backend="cuda", epoch=2, device=device)
    finally:
        if old is None:
            os.environ.pop("RESOLVER_KERNEL")
        else:
            os.environ["RESOLVER_KERNEL"] = old
    cs = role._cs
    on = "cuda" if device is None else str(device).split(":")[0]
    if type(cs).__name__ != "TorchConflictSet" or cs.device.type != on:
        fail(f"recovery parity: the role resolves on {type(cs).__name__}")
    rv = 2_000_000
    stale, fresh = 1_000, rv + 1_000

    async def wire():
        await role.resolve(ResolveTransactionBatchRequest(
            prev_version=-1, version=rv, last_received_version=-1, epoch=2))
        rep = await role.resolve(ResolveTransactionBatchRequest(
            prev_version=rv, version=rv + 1_000, last_received_version=rv,
            epoch=2,
            transactions=[gen.conservative_recovery_transaction(rv)]))
        if rep.committed[0] != TransactionResult.COMMITTED:
            fail("recovery parity: the recovery transaction did not commit")
        rep = await role.resolve(ResolveTransactionBatchRequest(
            prev_version=rv + 1_000, version=rv + 2_000,
            last_received_version=rv + 1_000, epoch=2,
            transactions=inflight_set(stale, fresh)))
        return ["commit" if v == TransactionResult.COMMITTED else "abort"
                for v in rep.committed]

    got = asyncio.run(wire())
    if not got == sim == LC_INFLIGHT_DECISIONS:
        fail(f"recovery parity: the card's role decided {got}, the sim "
             f"recovery {sim}, tests/test_lifecycle.py "
             f"{LC_INFLIGHT_DECISIONS}")
    return dict(decisions=got, sim=sim)


def lc_launch_check(tag: str, st: dict, uniform: dict, on: str) -> dict:
    """One recruited resolver's status: a TorchConflictSet on `on`, and
    its own launches (role_kernel_launches: those of its own resolves)
    phase 3's count a dispatched batch (tiered_launch_want), each kernel
    of the path at least once."""
    cs = st.get("conflict_set") or {}
    if cs.get("class") != "TorchConflictSet" or not str(
            cs.get("device", "")).startswith(on):
        fail(f"wire cluster: {tag} resolves on {cs}")
    launches = st["role_kernel_launches"]
    batches = st["qos"]["kernel"]["batches"]
    compactions = st["qos"]["kernel_stages"]["compactions"]
    want = tiered_launch_want(uniform, batches, compactions)
    for k, n in want.items():
        if launches.get(k, 0) != n or n <= 0:
            fail(f"wire cluster: {tag} launched {k} {launches.get(k, 0)} "
                 f"times in {batches} batches ({compactions} compactions), "
                 f"not {n}")
    q = st["qos"]
    return dict(batches=batches, compactions=compactions, launches=launches,
                txns=st["qos"]["resolve_path"]["txns"],
                compute_p50_ms=q["compute_time_dist"]["p50"] * 1e3,
                compute_p99_ms=q["compute_time_dist"]["p99"] * 1e3,
                warm_compile_s=st["qos"]["kernel_stages"]["compileSeconds"]["max"])


def phase_wire_cluster(card: str, uniform: dict, *,
                       records: int = COMMIT_RECORDS,
                       clients: int = COMMIT_CLIENTS, ops: int = COMMIT_OPS,
                       kernel_cfg=None, device=None, seed: int = 17) -> dict:
    """Cell LC: the wire cluster under its controller on the card.
    `python -m foundationdb_tpu_torch.cluster.monitor` starts the
    controller and LC_WORKERS workers (lc_conf); the controller recruits
    the nine roles onto them, both resolvers TorchConflictSets on the
    card. Phase 15's traffic from ClusterClients in this process: YCSB's
    load, every insert offered at once, then workload A, and at half of
    its operations acknowledged
    a SIGKILL of the worker hosting resolver1: the monitor restarts it,
    the controller recovers into a newer generation with both resolvers
    recruited anew, and the clients ride through with their retries.

    It fails unless: each recruited resolver is a TorchConflictSet on
    the card before and after the kill, with phase 3's launches a batch
    (lc_launch_check); the generation advances and its recovery version
    is above the last commit acknowledged before the kill; no committed
    transaction missed a conflict (missed_conflicts, over every
    transaction recorded at the client); every abort has a cause
    (unexplained_aborts); every acknowledged insert is in
    the storage role's snapshot at a fresh version, and a sample reads
    back through the front door; each counter lies between its
    acknowledged increments and those plus its unknown outcomes; a read
    at a snapshot from before the kill aborts after the recovery; no
    process but the killed worker exits, and none the monitor's log
    names is left after the monitor stops; the whole inside
    LC_BUDGET_S."""
    import asyncio
    import shutil
    import signal
    import subprocess
    import tempfile

    from foundationdb_tpu_torch.cluster import generation as gen
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.cluster.grv_proxy import GrvThrottledError
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.wire.codec import Mutation

    cfg = kernel_cfg or commit_config()
    on = "cuda" if device is None else str(device).split(":")[0]
    work = tempfile.mkdtemp(prefix="fdbl")
    rel = os.path.relpath(work)
    if len(rel) < len(work):
        work = rel  # a Unix socket path holds at most 107 bytes
    conf_path = lc_conf(work, cfg, device)
    ctrl = os.path.join(work, "controller0.sock")
    inputs = ycsb_a_inputs(seed, records, clients, ops)
    keys, values = inputs["keys"], inputs["values"]
    log(f"  deployment: the monitor, the controller and {LC_WORKERS} "
        f"workers ({LC_ROLES} roles and a spare); 2 tlogs, 1 storage, the "
        f"sequencer, 2 resolvers on {on} at RESOLVER_KERNEL={cfg!r}, a "
        f"ratekeeper, 2 proxies (max_batch {cfg.max_txns}, "
        f"{COMMIT_BATCH_INTERVAL * 1e3:g} ms); {records} records of "
        f"{COMMIT_FIELDS} x {COMMIT_FIELD_BYTES} bytes, {clients} clients x "
        f"{ops} operations of workload A")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    mon_log_path = os.path.join(work, "monitor.log")
    mon_log = open(mon_log_path, "w")
    t_start, t_start_wall = time.perf_counter(), time.time()
    monitor = subprocess.Popen(
        [sys.executable, "-u", "-m", "foundationdb_tpu_torch.cluster.monitor",
         conf_path], env=env, stdout=mon_log, stderr=subprocess.STDOUT)
    out: dict = dict(records=records, clients=clients, ops=ops, card=card,
                     workers=LC_WORKERS, roles=LC_ROLES)

    def since() -> float:
        return time.perf_counter() - t_start

    async def status_of(address: str) -> dict:
        conn = await mp.connect(address, retries=50)
        try:
            rep = await conn.call(mp.TOKEN_STATUS, mp.StatusRequest(pad=0),
                                  timeout=30.0)
            return json.loads(rep.payload)
        finally:
            await conn.close()

    async def resolvers_of(topo: dict) -> dict:
        return {n: await status_of(e["address"])
                for n, e in sorted(topo["roles"].items())
                if e["kind"] == "resolver"}

    async def drive():
        # -- the first recruitment
        first = mp.ClusterClient(ctrl, recovery_timeout=LC_BUDGET_S)
        await first.connect()
        topo0 = await first.topology()
        kinds = sorted(e["kind"] for e in topo0["roles"].values())
        if len(kinds) != LC_ROLES:
            fail(f"wire cluster: recruited {kinds}")
        recruited_s = since()
        cls = [mp.ClusterClient(ctrl, recovery_timeout=LC_RECOVERY_TIMEOUT)
               for _ in range(clients)]
        await asyncio.gather(*(c.connect() for c in cls))
        txns: list = []      # (read snapshot, version, reads, writes)
        acked: list = []     # (time.time(), version) of each ack
        aborts: list = []    # (key, read snapshot, reason, a later GRV)
        unknowns: list = []  # (key, read snapshot) of each unknown outcome
        counts = dict(reads=0, updates=0, conflicts=0, gave_up=0,
                      unknown=0, recovering=0, throttled=0)
        unknown = [0] * records
        updates = [0] * records
        commit_s, grv_s, read_s = [], [], []

        async def read_version(cl):
            while True:
                try:
                    return await cl.get_read_version()
                except GrvThrottledError:
                    counts["throttled"] += 1
                    await asyncio.sleep(0.01)

        # -- YCSB load: one insert a transaction, every one offered at
        # once as phase 15 offers them (a blind insert takes no read
        # version, so the GRV front door's queue limit does not bound it)
        async def insert(cl, i):
            k = keys[i]
            while True:
                try:
                    v = await cl.commit(CommitTransaction(
                        write_conflict_ranges=[(k, k + b"\x00")],
                        mutations=[Mutation(0, k, values[i])]))
                except mp.CommitUnknownError:
                    unknowns.append((k, 0))
                    continue  # a blind write of the same value: again
                except mp.ClusterRecoveringError:
                    continue
                txns.append((0, v, (), (k,)))
                acked.append((time.time(), v))
                return

        t0 = time.perf_counter()
        await asyncio.gather(*(insert(cls[n % clients], i)
                               for n, i in enumerate(inputs["insert_order"])))
        load_s = time.perf_counter() - t0
        first_commit_s = min(t for t, _v in acked) - t_start_wall
        log(f"  first recruitment: {LC_ROLES} roles in {recruited_s:.3f} s "
            f"from the monitor's start, the first commit at "
            f"{first_commit_s:.3f} s; on {card}")
        log(f"  load: {records} inserts in {load_s:.3f} s "
            f"({records / load_s:.1f} commits/s) on {card}")

        # -- YCSB workload A, the kill at half of its operations
        half = clients * ops // 2
        done = {"ops": 0}
        kill_now = asyncio.Event()
        gen1_st = {}

        async def client(c):
            cl = cls[c]
            for j in range(ops):
                rid = inputs["record"][c][j]
                key = keys[rid]
                conflicts = 0
                aborted = None  # the last abort, waiting for a later GRV
                while True:
                    try:
                        t1 = time.perf_counter()
                        rv = await cl.get_read_version()
                        t2 = time.perf_counter()
                        if aborted is not None:
                            aborts.append((*aborted, rv))
                            aborted = None
                        cur = await cl.read(key, rv)
                        grv_s.append(t2 - t1)
                        read_s.append(time.perf_counter() - t2)
                    except GrvThrottledError:
                        counts["throttled"] += 1
                        await asyncio.sleep(0.01)
                        continue
                    if cur is None or len(cur) != len(values[rid]):
                        fail(f"wire cluster: record {rid} read {cur!r:.40}")
                    if inputs["is_read"][c][j]:
                        counts["reads"] += 1
                        break
                    f = inputs["field"][c][j] * COMMIT_FIELD_BYTES
                    new = ((int.from_bytes(cur[:8], "little") + 1)
                           .to_bytes(8, "little") + cur[8:f]
                           + inputs["new_field"][c, j].tobytes()
                           + cur[f + COMMIT_FIELD_BYTES:])
                    kr = (key, key + b"\x00")
                    t3 = time.perf_counter()
                    try:
                        v = await cl.commit(CommitTransaction(
                            read_conflict_ranges=[kr],
                            write_conflict_ranges=[kr], read_snapshot=rv,
                            mutations=[Mutation(0, key, new)]))
                    except mp.NotCommittedError as e:
                        aborted = (key, rv, "TOO_OLD" if "TOO_OLD" in str(e)
                                   else "CONFLICT")
                        counts["conflicts"] += 1
                        conflicts += 1
                        if conflicts > COMMIT_RETRIES:
                            counts["gave_up"] += 1
                            aborts.append((*aborted, await read_version(cl)))
                            break
                        continue
                    except mp.CommitUnknownError:
                        counts["unknown"] += 1
                        unknown[rid] += 1
                        unknowns.append((key, rv))
                        continue
                    except mp.ClusterRecoveringError:
                        counts["recovering"] += 1
                        continue
                    except GrvThrottledError:
                        counts["throttled"] += 1
                        await asyncio.sleep(0.01)
                        continue
                    commit_s.append(time.perf_counter() - t3)
                    txns.append((rv, v, (key,), (key,)))
                    acked.append((time.time(), v))
                    updates[rid] += 1
                    counts["updates"] += 1
                    break
                done["ops"] += 1
                if done["ops"] >= half:
                    kill_now.set()

        async def killer():
            await kill_now.wait()
            topo = await first.topology()
            epoch0, recovery0 = topo["epoch"], topo["recovery_version"]
            # a throttled GRV is retried, as every client's is
            stale_rv = await read_version(first)
            gen1_st.update(await resolvers_of(topo))
            victim = topo["roles"]["resolver1"]
            t_kill = time.time()
            os.kill(victim["pid"], signal.SIGKILL)
            k_s = since()
            while True:
                try:
                    topo = await first.topology()
                    if (topo["epoch"] > epoch0
                            and topo["state"] == gen.FULLY_RECOVERED):
                        break
                except Exception:  # noqa: BLE001 - polled again
                    pass
                if since() > LC_BUDGET_S:
                    fail(f"wire cluster: no recovery by {since():.1f} s: "
                         f"{topo}")
                await asyncio.sleep(0.05)
            return dict(epoch0=epoch0, recovery0=recovery0, topo=topo,
                        stale_rv=stale_rv,
                        victim=victim, t_kill=t_kill, kill_at_s=k_s,
                        recovered_at_s=since())

        t0 = time.perf_counter()
        kill_task = asyncio.ensure_future(killer())
        await asyncio.gather(*(client(c) for c in range(clients)))
        run_s = time.perf_counter() - t0
        kill = await kill_task
        kill["last_acked"] = max(v for t, v in acked if t <= kill["t_kill"])
        topo1 = kill["topo"]
        rv1 = topo1["recovery_version"]
        gen2_st = await resolvers_of(topo1)
        after = sorted((t, v) for t, v in acked if v > rv1)
        if not after:
            fail("wire cluster: no commit acknowledged in the new "
                 "generation")

        # -- check 4: a read at a snapshot from before the kill aborts
        stale_txn = CommitTransaction(
            read_conflict_ranges=[(LC_STALE_KEY, LC_STALE_KEY + b"\x00")],
            write_conflict_ranges=[(LC_STALE_KEY, LC_STALE_KEY + b"\x00")],
            read_snapshot=kill["stale_rv"],
            mutations=[Mutation(0, LC_STALE_KEY, b"stale")])
        for _ in range(100):
            try:
                v = await first.commit(stale_txn)
                fail(f"wire cluster: a read at the pre-kill snapshot "
                     f"{kill['stale_rv']} committed at {v}")
            except mp.NotCommittedError:
                break
            except (mp.CommitUnknownError, mp.ClusterRecoveringError):
                await asyncio.sleep(0.05)
        else:
            fail("wire cluster: the pre-kill snapshot's read never "
                 "resolved")

        # -- the read-back at a fresh version
        head = await first.get_read_version()
        snap_conn = await mp.connect(topo1["roles"]["storage0"]["address"])
        snap = await snap_conn.call(mp.TOKEN_STORAGE_SNAPSHOT,
                                    mp.StorageSnapshotReq(version=head),
                                    timeout=300.0)
        await snap_conn.close()
        sample = np.random.default_rng(seed).choice(
            records, size=min(LC_READ_BACK, records), replace=False)
        front = await asyncio.gather(*(
            cls[n % clients].read(keys[int(r)], head)
            for n, r in enumerate(sample)))
        ctrl_st = await status_of(ctrl)
        for cl in (first, *cls):
            await cl.close()
        return dict(txns=txns, acked=acked, counts=counts, unknown=unknown,
                    aborts=aborts, unknowns=unknowns,
                    updates=updates, commit_s=commit_s, run_s=run_s,
                    load_s=load_s,
                    kill=kill, gen1=gen1_st, gen2=gen2_st, after=after,
                    snap=snap, head=head, sample=sample, front=front,
                    ctrl=ctrl_st, topo0=topo0, first_commit_s=first_commit_s,
                    recruited_s=recruited_s, grv_s=grv_s, read_s=read_s)

    try:
        r = asyncio.run(drive())
    except BaseException:
        # the monitor's log (its children's output too) says what died
        mon_log.flush()
        with open(mon_log_path) as f:
            tail = f.read().splitlines()[-60:]
        print("\n".join(["  monitor log, last lines:", *tail]),
              file=sys.stderr, flush=True)
        raise
    finally:
        # teardown: the monitor stops (and reaps) its children on SIGTERM
        monitor.send_signal(signal.SIGTERM)
        try:
            monitor.wait(timeout=60)
        except subprocess.TimeoutExpired:
            monitor.kill()
            monitor.wait()
        mon_log.close()
        with open(mon_log_path) as f:
            mon_lines = f.read().splitlines()
        leftover = [p for p in launched_pids(mon_lines) if running(p)]
        for p in leftover:
            os.kill(p, signal.SIGKILL)
    wall_s = time.perf_counter() - t_start
    shutil.rmtree(work, ignore_errors=True)
    if leftover:
        fail(f"wire cluster: {leftover} still ran after the monitor stopped")
    kill, counts = r["kill"], r["counts"]
    victim_worker = kill["victim"]["worker"]
    died = [ln for ln in mon_lines if " died rc=" in ln]
    if len(died) != 1 or not died[0].startswith(
            f"[monitor] {victim_worker} died rc=-9"):
        fail(f"wire cluster: processes that exited: {died}")
    relaunched = [ln for ln in mon_lines
                  if ln.startswith(f"[monitor] launched {victim_worker} ")]
    if len(relaunched) != 2:
        fail(f"wire cluster: the monitor launched {victim_worker} "
             f"{len(relaunched)} times")
    if monitor.returncode not in (0, -signal.SIGTERM):
        fail(f"wire cluster: the monitor exited with {monitor.returncode}")

    # 1. the generations, the resolvers on the card, their launches
    topo0, topo1 = r["topo0"], kill["topo"]
    if not topo1["epoch"] > kill["epoch0"] >= topo0["epoch"]:
        fail(f"wire cluster: epochs {topo0['epoch']}, {kill['epoch0']}, "
             f"{topo1['epoch']}")
    if not topo1["recovery_version"] > kill["last_acked"]:
        fail(f"wire cluster: recovery version {topo1['recovery_version']} "
             f"not above the last acknowledged commit {kill['last_acked']}")
    gens = {}
    for tag, sts in (("generation 1", r["gen1"]),
                     ("generation 2", r["gen2"])):
        if sorted(sts) != ["resolver0", "resolver1"]:
            fail(f"wire cluster: {tag}'s resolvers {sorted(sts)}")
        gens[tag] = {n: lc_launch_check(f"{tag} {n}", st, uniform, on)
                     for n, st in sts.items()}
    if (topo1["roles"]["resolver1"]["pid"] == kill["victim"]["pid"]
            or any(st["epoch"] != topo1["epoch"]
                   for st in r["gen2"].values())):
        fail("wire cluster: generation 2's resolvers are not new recruits")
    # 2. no missed conflict
    bad = missed_conflicts(r["txns"])
    if bad:
        fail(f"wire cluster: {len(bad)} committed transactions missed a "
             f"conflict, the first {bad[:3]}")
    if len(r["aborts"]) != counts["conflicts"]:
        fail(f"wire cluster: {len(r['aborts'])} aborts recorded of "
             f"{counts['conflicts']}")
    bad = unexplained_aborts(
        r["aborts"], r["txns"], r["unknowns"],
        [topo0["recovery_version"], kill["recovery0"],
         topo1["recovery_version"]], cfg.window_versions)
    if bad:
        fail(f"wire cluster: {len(bad)} of {len(r['aborts'])} aborts have no "
             f"cause, the first {bad[:3]}")
    # 3. every acknowledged insert, and the counters' bounds
    kv = dict(r["snap"].kvs)
    for rid in range(records):
        val = kv.get(keys[rid])
        if val is None:
            fail(f"wire cluster: record {rid} is not in the snapshot")
        n = int.from_bytes(val[:8], "little")
        lo, hi = r["updates"][rid], r["updates"][rid] + r["unknown"][rid]
        if not lo <= n <= hi:
            fail(f"wire cluster: record {rid}'s counter {n} is outside "
                 f"[{lo}, {hi}]")
        if hi == 0 and val != values[rid]:
            fail(f"wire cluster: record {rid} is not its insert")
    for rid, got in zip(r["sample"], r["front"]):
        if got != kv[keys[int(rid)]]:
            fail(f"wire cluster: record {int(rid)} reads back otherwise "
                 "through the front door")

    # the numbers
    ctrl_q = r["ctrl"]["qos"]
    at = {row["status"]: row["time"] for row in ctrl_q["recovery_timeline"]
          if row["epoch"] == topo1["epoch"]}
    first_after = r["after"][0][0]
    attempts = counts["updates"] + counts["conflicts"]
    p50, p99 = quantiles_ms(r["commit_s"])
    grv50, grv99 = quantiles_ms(r["grv_s"])
    read50, read99 = quantiles_ms(r["read_s"])
    recovery = dict(
        kill_to_first_commit_s=first_after - kill["t_kill"],
        detection_s=at[gen.READING_TRANSACTION_SYSTEM_STATE]
        - kill["t_kill"],
        walk_s=at[gen.FULLY_RECOVERED]
        - at[gen.READING_TRANSACTION_SYSTEM_STATE],
        recruiting_s=at[gen.RECOVERY_TRANSACTION]
        - at[gen.RECRUITING_TRANSACTION_SERVERS],
        resolver_warm_up_s=[g["warm_compile_s"]
                            for _n, g in sorted(gens["generation 2"].items())],
        recovered_to_first_commit_s=first_after - at[gen.FULLY_RECOVERED],
        reason=ctrl_q["last_recovery_reason"],
        death_notifications=ctrl_q["death_notifications"],
        epochs=[topo0["epoch"], topo1["epoch"]],
        recovery_version=topo1["recovery_version"],
        last_acked_before_kill=kill["last_acked"],
        kill_at_s=kill["kill_at_s"], recovered_at_s=kill["recovered_at_s"])
    out.update(
        phase_wall_s=wall_s, recruited_s=r["recruited_s"],
        first_commit_s=r["first_commit_s"],
        load=dict(seconds=r["load_s"], commits_per_s=records / r["load_s"]),
        workload=dict(
            seconds=r["run_s"], reads=counts["reads"],
            committed=counts["updates"], conflicted=counts["conflicts"],
            unknown=counts["unknown"], recovering=counts["recovering"],
            throttled=counts["throttled"], gave_up=counts["gave_up"],
            abort_share=counts["conflicts"] / max(1, attempts),
            commits_per_s=counts["updates"] / r["run_s"],
            commit_p50_ms=p50, commit_p99_ms=p99, grv_p50_ms=grv50,
            grv_p99_ms=grv99, read_p50_ms=read50, read_p99_ms=read99),
        recovery=recovery, resolvers=gens,
        checks=dict(transactions=len(r["txns"]), aborts=len(r["aborts"]),
                    snapshot_keys=len(kv),
                    read_back=len(r["sample"]),
                    stale_snapshot=kill["stale_rv"]))
    w, rc = out["workload"], recovery
    log(f"  workload A: {w['committed']} updates committed, "
        f"{w['conflicted']} conflicted (abort share {w['abort_share']:.4f}, "
        f"{w['gave_up']} gave up), {w['unknown']} unknown outcomes, "
        f"{w['recovering']} refused while recovering, {w['throttled']} GRVs "
        f"throttled, {w['reads']} reads in {w['seconds']:.3f} s: "
        f"{w['commits_per_s']:.1f} commits/s; commit p50 "
        f"{w['commit_p50_ms']:.3f} ms, p99 {w['commit_p99_ms']:.3f} ms, GRV "
        f"p50 {grv50:.3f} ms, p99 {grv99:.3f} ms, read p50 {read50:.3f} "
        f"ms, p99 {read99:.3f} ms at the client; on {card}")
    log(f"  kill -9 of {victim_worker} (resolver1) at {rc['kill_at_s']:.3f} "
        f"s: the first commit of generation {topo1['epoch']} "
        f"{rc['kill_to_first_commit_s']:.3f} s later: detection "
        f"{rc['detection_s']:.3f} s ({rc['reason']}), the recovery walk "
        f"{rc['walk_s']:.3f} s (recruiting {rc['recruiting_s']:.3f} s, the "
        f"new resolvers' warm-up "
        f"{[round(x, 3) for x in rc['resolver_warm_up_s']]} s), then "
        f"{rc['recovered_to_first_commit_s']:.3f} s to the first commit; "
        f"recovery version {rc['recovery_version']} above the last "
        f"acknowledged {rc['last_acked_before_kill']}; on {card}")
    for tag, g in gens.items():
        for n, st in sorted(g.items()):
            log(f"  {tag} {n}: {st['batches']} batches, mean "
                f"{st['txns'] / max(1, st['batches']):.1f} txns, "
                f"{st['compactions']} compactions; compute p50 "
                f"{st['compute_p50_ms']:.3f} ms, p99 "
                f"{st['compute_p99_ms']:.3f} ms a batch; warm-up "
                f"{st['warm_compile_s']:.3f} s; on {card}")
    log(f"  checks: {LC_ROLES} roles recruited, generation "
        f"{topo0['epoch']} -> {topo1['epoch']}, every resolver a "
        f"TorchConflictSet on {on} with phase 3's launches a batch, no "
        f"missed conflict in {len(r['txns'])} committed transactions, "
        f"a cause for each of {len(r['aborts'])} aborts, "
        f"{len(kv)} records in the storage snapshot at {r['head']} with "
        f"their counters in bounds, {len(r['sample'])} read back through "
        f"the front door, the pre-kill snapshot's read aborted, one "
        f"process exited (the killed worker, relaunched), none left; phase "
        f"wall {wall_s:.1f} s of the {LC_BUDGET_S:.0f} s budget; on {card}")
    if wall_s > LC_BUDGET_S:
        fail(f"wire cluster: the phase took {wall_s:.1f} s, over its "
             f"{LC_BUDGET_S:.0f} s budget")
    return out


# ---------------------------------------------------------------------------
# phase 18: the spec-driven simulation ensemble on the card (cell EN)

#: the phase's wall budget, from its first run to its last comparison
EN_BUDGET_S = 240.0
#: the seeds that draw the device backend, each at its spec's own shape
#: (testing/specs/*.toml: 64-txn batches of 256 reads and writes, 16-byte
#: keys, a 1M or 5M-version window): api_correctness 1 classic, 6 tiered
#: with read dedup and backup_restore, 8 on 2 shards with knob_quorum, 13
#: classic; range_heavy 1 and 8 the sweep with spill (8 on 2 shards);
#: ycsb_d 6 tiered, 11 classic
EN_SEEDS = (("api_correctness", 1), ("api_correctness", 6),
            ("api_correctness", 8), ("api_correctness", 13),
            ("range_heavy", 1), ("range_heavy", 8),
            ("ycsb_d", 6), ("ycsb_d", 11))
#: run again on the card, in the same process: the rerun-identical check
EN_RERUN = ("api_correctness", 8)
#: run on the card with the span-chain gate, the census gate and the
#: status probe armed; its trace digest must equal the plain versions'
EN_TRACED = ("api_correctness", 6, {"trace": True, "census": True,
                                    "status_probe": True})
#: spawned processes that run the card's runs (each with its own CUDA
#: context: a run is the host's Python and launches, so two share the
#: card), and those that run the plain-version twins on the host's cores,
#: one torch thread each
EN_CARD_WORKERS = 2
EN_WORKERS = 4
#: what every device seed's path launches: the K15 chain of PERF.md § 6
#: (A's counts, probe and query, B, C, D, L, N)
EN_CHAIN = ("keysearch.counts", "keysearch.probe", "keysearch.query",
            "rangemax_build", "min_cover", "merge_maps", "sort_ranks",
            "lex_order")


def en_kernels(cfg) -> tuple:
    """The kernels a resolver on `cfg` launches in a soak seed: the chain
    always; F where the seed's tiered config dedups reads (even seeds,
    testing/soak.py), E where range_heavy arms the sweep, I and J where
    the seed shards the keyspace (seed % 4 == 0)."""
    want = list(EN_CHAIN)
    if cfg.dedup_reads:
        want.append("read_dedup")
    if cfg.range_sweep:
        want.append("sweep_ranks")
    if cfg.n_shards > 1:
        want += ["shard_clip", "shard_combine"]
    return tuple(want)


def en_call(job: tuple, device):
    """One run of the phase on `device`: a soak seed's signature, the
    saturation ramp's report or a hotspot sim leg's report."""
    kind, args, kw = job
    if kind == "seed":
        from foundationdb_tpu_torch.testing.soak import run_seed

        return run_seed(*args, device=device, **kw)
    if kind == "saturation":
        from foundationdb_tpu_torch.testing.saturation import run_saturation

        return run_saturation(device=device, **kw)
    from foundationdb_tpu_torch.testing.hotspot import run_hotspot_sim

    return run_hotspot_sim(device=device, **kw)


def en_twin(job: tuple):
    """One plain-version twin in a worker process (one torch thread, no
    CUDA): `en_call` with device="cpu", and its wall."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = en_call(job, "cpu")
    return out, time.perf_counter() - t0


def en_resolvers_kernels(tag: str, built: list, on: str) -> set:
    """Fail unless `built` holds resolvers and each is a TorchConflictSet
    on the device type `on`; the kernels their configs' paths launch."""
    if not built:
        fail(f"{tag}: no resolver was built")
    want = set()
    for r in built:
        cs = r.conflict_set
        if type(cs).__name__ != "TorchConflictSet" or cs.device.type != on:
            fail(f"{tag}: resolver {r.resolver_id} resolves on "
                 f"{type(cs).__name__} ({getattr(cs, 'device', None)})")
        want.update(en_kernels(cs.config))
    return want


def en_on_card(tag: str, job: tuple, device) -> dict:
    """Run one job on `device` with the launch counts from 0 and every
    port Resolver it builds recorded; fail unless each is a
    TorchConflictSet on `device` (the card when None) and every kernel
    its config's path launches (`en_kernels`) launched. Returns the
    result, wall, launches, batches and device memory after it."""
    import gc

    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.resolver import Resolver

    built = []
    init = Resolver.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    Resolver.__init__ = record
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        result = en_call(job, device)
    finally:
        Resolver.__init__ = init
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.counts().items() if n}
    on = "cuda" if device is None else str(device)
    want = en_resolvers_kernels(tag, built, on)
    missing = sorted(k for k in want if not launches.get(k))
    if missing:
        fail(f"{tag}: {missing} never launched on the card (launched "
             f"{launches})")
    out = dict(result=result, wall_s=wall, launches=launches,
               resolvers=len(built),
               batches=sum(r.conflict_set.metrics.counters.get(
                   "resolveBatches") for r in built))
    # the run's clusters are stopped: once these references go, nothing
    # of theirs may stay on the card
    built.clear()
    gc.collect()
    if on == "cuda":
        torch.cuda.synchronize()
    out["memory_allocated"] = (torch.cuda.memory_allocated()
                               if on == "cuda" else 0)
    return out


def en_card_worker(jobs: list, device) -> dict:
    """In a spawned process with its own CUDA context: each (tag, job) of
    `jobs` in order through `en_on_card`; fails unless the allocated
    memory after the worker's repeated runs (those not in EN_SEEDS) is
    at most its level after its runs of EN_SEEDS."""
    runs = {tag: en_on_card(tag, job, device) for tag, job in jobs}
    first_pass = {f"{s} {n}" for s, n in EN_SEEDS}
    mem_first = max((r["memory_allocated"] for tag, r in runs.items()
                     if tag in first_pass), default=0)
    mem_later = max((r["memory_allocated"] for tag, r in runs.items()
                     if tag not in first_pass), default=0)
    if mem_later > mem_first:
        fail(f"ensemble: the card's allocated memory grew from {mem_first} "
             f"to {mem_later} bytes over the repeated runs ({list(runs)})")
    return runs


def phase_ensemble(card: str, device=None) -> dict:
    """The spec-driven simulation ensemble on the card (cell EN): each of
    EN_SEEDS through `testing/soak.run_seed` on the card, inside its
    whole fault mix, with every gate of run_seed (no unhandled actor
    error, no auditor conflict, the model checks, the ApiCorrectness
    cross-check, the consistency check, the backup/restore comparison);
    its signature equal to the same seed's with device="cpu" (the plain
    versions); EN_RERUN again on the card in the same process,
    identical; EN_TRACED on the card with the span-chain, census and
    status-probe gates, its digest the plain versions'; the saturation
    ramp (quick, admission on) and the hotspot gate's sim legs (zipf,
    uniform) on the card, each report the plain versions'. The card's
    runs go to EN_CARD_WORKERS spawned processes, the twins meanwhile to
    EN_WORKERS more. Every resolver of every epoch is a TorchConflictSet
    on the card and every kernel of its config's path launches in each
    run; no worker's allocated memory grows over its repeated runs; the
    whole inside EN_BUDGET_S."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from foundationdb_tpu_torch.testing import soak

    t_phase = time.perf_counter()
    jobs = {}
    for spec, seed in EN_SEEDS:
        plan = soak.plan_for_seed(seed, spec)
        if plan.resolver_backend != "cuda":
            fail(f"ensemble: {spec} {seed} draws {plan.resolver_backend!r}")
        jobs[f"{spec} {seed}"] = ("seed", (seed, spec), {})
    spec, seed, kw = EN_TRACED
    jobs[f"{spec} {seed} traced"] = ("seed", (seed, spec), kw)
    jobs["saturation"] = ("saturation", (), {"admission": True,
                                            "quick": True})
    for skewed in (True, False):
        jobs[f"hotspot {'zipf' if skewed else 'uniform'}"] = (
            "hotspot", (), {"skewed": skewed, "quick": True})
    base = "{} {}".format(*EN_RERUN)
    rerun = base + " rerun"

    def weight(tag):
        # a 2-shard seed (seed % 4 == 0) takes about four times another
        # run, on the card and as a twin
        job = jobs[tag]
        return 4 if job[0] == "seed" and job[1][0] % 4 == 0 else 1

    longest = sorted(jobs, key=weight, reverse=True)
    # the card's runs go to its workers longest first, each to the least
    # loaded; the rerun rides with its seed, in the same process
    card_jobs = [[] for _ in range(EN_CARD_WORKERS)]
    load = [0] * EN_CARD_WORKERS
    for tag in longest:
        i = load.index(min(load))
        card_jobs[i].append((tag, jobs[tag]))
        load[i] += weight(tag)
        if tag == base:
            card_jobs[i].append((rerun, jobs[base]))
            load[i] += weight(tag)
    ctx = multiprocessing.get_context("spawn")
    twin_pool = ProcessPoolExecutor(max_workers=EN_WORKERS, mp_context=ctx)
    card_pool = ProcessPoolExecutor(max_workers=EN_CARD_WORKERS,
                                    mp_context=ctx)
    try:
        twins = {tag: twin_pool.submit(en_twin, jobs[tag])
                 for tag in longest}
        on_card = [card_pool.submit(en_card_worker, lst, device)
                   for lst in card_jobs]
        card_runs = {}
        for f in on_card:
            card_runs.update(f.result())
        t_twins = time.perf_counter()
        twin = {tag: f.result() for tag, f in twins.items()}
        twin_wait = time.perf_counter() - t_twins
    finally:
        card_pool.shutdown(wait=True, cancel_futures=True)
        twin_pool.shutdown(wait=True, cancel_futures=True)
    if card_runs[rerun]["result"] != card_runs[base]["result"]:
        fail(f"ensemble: {base} on the card is not rerun-identical")
    for tag, run in card_runs.items():
        want = twin[tag.removesuffix(" rerun")][0]
        if run["result"] != want:
            fail(f"ensemble: {tag} on the card differs from its plain "
                 f"versions: {run['result']!r} against {want!r}")
    if not card_runs["saturation"]["result"]["slo"]["passed"]:
        fail("ensemble: the saturation ramp violated its SLO gate")
    for tag in ("hotspot zipf", "hotspot uniform"):
        if not card_runs[tag]["result"]["ok"]:
            fail(f"ensemble: {tag}: {card_runs[tag]['result']['why']}")
    wall_s = time.perf_counter() - t_phase
    out = dict(card=card, phase_wall_s=wall_s, twin_wait_s=twin_wait,
               card_workers=[[tag for tag, _ in lst] for lst in card_jobs],
               runs={})
    for tag, run in card_runs.items():
        res = run["result"]
        row = dict(wall_s=run["wall_s"], resolvers=run["resolvers"],
                   batches=run["batches"], launches=run["launches"],
                   launches_per_batch={
                       k: n / max(run["batches"], 1)
                       for k, n in run["launches"].items()},
                   memory_allocated=run["memory_allocated"],
                   plain_wall_s=twin[tag.removesuffix(" rerun")][1])
        if isinstance(res, tuple):
            m = soak.signature_metrics(res)
            row.update(committed=m["committed"], aborted=m["aborted"],
                       epoch=m["epoch"], virtual_s=m["virtual_seconds"],
                       api=list(m["api"]) if m["api"] else None,
                       trace_digest=m.get("trace_digest"))
            log(f"  {tag}: {run['wall_s']:.2f} s on the card (plain "
                f"versions {row['plain_wall_s']:.2f} s), committed "
                f"{m['committed']}, aborted {m['aborted']}, epoch "
                f"{m['epoch']}, {run['resolvers']} resolvers, "
                f"{run['batches']} batches; launched {run['launches']}; "
                f"memory_allocated {run['memory_allocated']}")
        else:
            log(f"  {tag}: {run['wall_s']:.2f} s on the card (plain "
                f"versions {row['plain_wall_s']:.2f} s), the report equal; "
                f"{run['batches']} batches; launched {run['launches']}; "
                f"memory_allocated {run['memory_allocated']}")
        out["runs"][tag] = row
    log(f"  every signature and report equal to the plain versions', "
        f"{base} rerun-identical, every resolver of every epoch a "
        f"TorchConflictSet on the card, every path kernel launched, no "
        f"memory growth; the card's runs in {EN_CARD_WORKERS} processes "
        f"{out['card_workers']}; waited {twin_wait:.2f} s for the twins; "
        f"phase wall {wall_s:.1f} s of the {EN_BUDGET_S:.0f} s budget; on "
        f"{card}")
    if wall_s > EN_BUDGET_S:
        fail(f"ensemble: the phase took {wall_s:.1f} s, over its "
             f"{EN_BUDGET_S:.0f} s budget")
    return out


# ---------------------------------------------------------------------------
# phase 19: the features beside the commit path on the card (cell FX)

#: the phase's wall budget, from its first run to its last comparison
FX_BUDGET_S = 180.0
#: each leg at full size (PERF.md § 4 lists the cuts): DR at phase 16's
#: traffic (YCSB's load of 100,000 1 KB records, workload A from 256
#: clients x 40 ops); multi-region 20,000 records, then `updates` more
#: acknowledged while the router is cut off; the metacluster's 24
#: tenants of 1,000 records, each with 8 clients x 10 workload-A ops;
#: backup and restore at 6,000 records (ParallelRestore commits one
#: transaction an applier, and a batch holds at most max_writes = 4,096
#: write ranges a resolver: two appliers' halves land on one), the
#: granules over the first 1,000; the layers' HCA under 32 clients and
#: 1,000 TaskBucket tasks
FX_FULL = {
    "dr": dict(records=COMMIT_RECORDS, clients=COMMIT_CLIENTS,
               ops=COMMIT_OPS),
    "multiregion": dict(records=20_000, updates=2_000),
    "metacluster": dict(tenants=24, keys=1_000, clients=8, ops=10),
    "backup": dict(records=6_000, clients=64, ops=10, granule_records=1_000),
    "layers": dict(hca_clients=32, hca_each=8, tasks=1_000, executors=4),
}
#: each leg's twin: run on the card and with device="cpu" (the plain
#: versions) in spawned processes at FX_TWIN_CONFIG, digests equal
FX_TWIN = {
    "dr": dict(records=1_000, clients=16, ops=5),
    "multiregion": dict(records=1_000, updates=200),
    "metacluster": dict(tenants=4, keys=50, clients=2, ops=5),
    "backup": dict(records=400, clients=8, ops=5, granule_records=200),
    "layers": dict(hca_clients=8, hca_each=4, tasks=60, executors=3),
}
#: the spawned processes that run the card's legs (DR, the long pole, in
#: one; the other four in the other) and those that run the twins'
#: plain versions, one torch thread each
FX_CARD_WORKERS = (("dr",), ("multiregion", "metacluster", "backup",
                             "layers"))
FX_WORKERS = 4
#: a leg's loader tasks at most (phase 16's, under the GRV queue limit)
FX_LOADERS = SIM_LOADERS


def fx_twin_config():
    """The twins' conflict-set config: the tiered path at 256 txns and
    reads and writes a batch, 16-byte keys, a 16,384-row main and a
    4,096-row delta tier, the 5,000,000-version window (the plain
    versions pay the padded shape each batch: commit_config() would
    take minutes a twin on the host)."""
    return bench_config(256, max_key_bytes=16, history_capacity=1 << 14,
                        delta_capacity=1 << 12, window_versions=ROLE_WINDOW)


def fx_norm(x):
    """A process-independent form of a result: dataclasses by class name
    and fields, errors by class name, sets sorted."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, fx_norm(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    if isinstance(x, BaseException):
        return ("error", type(x).__name__)
    if isinstance(x, dict):
        return {fx_norm(k): fx_norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [fx_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((fx_norm(v) for v in x), key=repr)
    if isinstance(x, np.generic):
        return x.item()
    return x


def fx_digest(parts: dict) -> dict:
    """Each part's sha256 over its normalized repr: what a twin compares
    (the results, every storage snapshot, the virtual time, the probes
    hit)."""
    import hashlib

    return {k: hashlib.sha256(repr(fx_norm(v)).encode()).hexdigest()
            for k, v in parts.items()}


def fx_run(sched, coro):
    t = sched.spawn(coro, name="fx")
    sched.run_until(t.done)
    return t.done.get()


async def fx_outcome(coro):
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the class is the result
        return ("err", type(e).__name__)


def fx_open(cfg, device, sched=None, **kw):
    from foundationdb_tpu_torch.cluster.database import (ClusterConfig,
                                                         open_cluster)

    return open_cluster(ClusterConfig(resolver_backend="cuda", device=device,
                                      kernel_config=cfg, **kw), sched=sched)


def fx_stop(sched, clusters: list) -> list:
    """Stop the clusters, drain the cancellations; the unhandled actor
    errors left (a leg fails on any)."""
    for c in clusters:
        c.stop()
    sched.run_for(1.0)
    return sorted((n, type(e).__name__) for n, e in sched.unhandled_errors())


def fx_snapshots(clusters: list) -> list:
    return [[ss.snapshot() for ss in c.storage_servers] for c in clusters]


def fx_user_rows(db, sched, begin=b"", end=b"\xff") -> dict:
    """Every row in [begin, end) at a fresh read version, through the
    client."""
    async def read():
        return dict(await db.create_transaction().get_range(begin, end))
    return fx_run(sched, read())


async def fx_load(sched, run_insert, order, loaders: int):
    """YCSB's loader threads: each inserts its share of `order` in turn
    through `run_insert(i)`."""
    from foundationdb_tpu_torch.runtime.flow import all_of

    async def loader(share):
        for i in share:
            await run_insert(i)

    n = max(1, min(loaders, len(order)))
    tasks = [sched.spawn(loader(order[k::n]), name=f"fx-load{k}")
             for k in range(n)]
    await all_of([t.done for t in tasks])


def fx_inserter(db, keys: list, values: list, committed: list,
                tenant: bool = False):
    """YCSB's insert of record i through `db.run` (a Database's or a
    Tenant's, whose set is awaited), recorded in `committed` with its
    commit version."""
    async def insert(i):
        attempts = []

        async def write(txn):
            attempts.append(txn)
            if tenant:
                await txn.set(keys[i], values[i])
            else:
                txn.set(keys[i], values[i])

        await db.run(write)
        committed.append((attempts[-1].committed_version, keys[i],
                          values[i]))
    return insert


def fx_rmw(cur: bytes, inputs: dict, c: int, j: int) -> bytes:
    """Workload A's read-modify-write: the counter + 1 and one field
    replaced (phase 16's update)."""
    f = inputs["field"][c][j] * COMMIT_FIELD_BYTES
    return ((int.from_bytes(cur[:8], "little") + 1).to_bytes(8, "little")
            + cur[8:f] + inputs["new_field"][c, j].tobytes()
            + cur[f + COMMIT_FIELD_BYTES:])


async def fx_workload(sched, create, inputs: dict, clients: int, ops: int,
                      keys: list, committed: list, counts: dict,
                      tenant: bool = False):
    """Workload A from `clients` tasks of `ops` operations: a read is a
    transaction's get, an update a read-modify-write committed with its
    read and retried on NotCommitted up to COMMIT_RETRIES times.
    `create()` opens a transaction (a Database's, or a Tenant's, whose
    set is awaited)."""
    from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted
    from foundationdb_tpu_torch.runtime.flow import all_of

    async def client(c):
        for j in range(ops):
            key = keys[inputs["record"][c][j]]
            for _attempt in range(1 + COMMIT_RETRIES):
                txn = create()
                cur = await txn.get(key)
                if cur is None:
                    fail(f"features: record {key!r} missing before its "
                         "update")
                if inputs["is_read"][c][j]:
                    counts["reads"] += 1
                    break
                new = fx_rmw(cur, inputs, c, j)
                if tenant:
                    await txn.set(key, new)
                else:
                    txn.set(key, new)
                try:
                    await txn.commit()
                except NotCommitted:
                    counts["conflicts"] += 1
                    continue
                committed.append((txn.committed_version, key, new))
                counts["updates"] += 1
                break
            else:
                counts["gave_up"] += 1

    tasks = [sched.spawn(client(c), name=f"fx-client{c}")
             for c in range(clients)]
    await all_of([t.done for t in tasks])


def fx_replay(committed: list) -> dict:
    want = {}
    for _v, k, val in sorted(committed, key=lambda c: c[0]):
        want[k] = val
    return want


def fx_leg_dr(size: dict, device, cfg, seed: int = 19) -> dict:
    """DR (cluster/dr.py) between two `sim_cluster_config` clusters on
    one scheduler: a DrAgent locks the empty destination and tails the
    source's full stream while YCSB's load and workload A run on the
    source; a plain write to the destination raises
    DestinationLockedError; `switchover()` locks the source, drains and
    unlocks the destination. Then the destination's rows equal the
    source's at the takeover version, and every acknowledged insert and
    update reads back from the destination as the replay of the
    committed mutations."""
    from foundationdb_tpu_torch.cluster.database import open_cluster
    from foundationdb_tpu_torch.cluster.dr import DrAgent
    from foundationdb_tpu_torch.runtime.flow import Scheduler

    records, clients, ops = size["records"], size["clients"], size["ops"]
    inputs = ycsb_a_inputs(seed, records, clients, ops)
    keys, values = inputs["keys"], inputs["values"]
    sched = Scheduler(sim=True)
    _s, src, src_db, _s, dst, dst_db = (
        *open_cluster(sim_cluster_config(records, "cuda", device, cfg),
                      sched=sched),
        *open_cluster(sim_cluster_config(records, "cuda", device, cfg),
                      sched=sched))
    agent = DrAgent(src, src_db, dst_db)
    applies = [0, 0]
    apply_one = agent._apply_one

    async def counted(version, mutations):
        await apply_one(version, mutations)
        applies[0] += 1
        applies[1] += len(mutations)

    agent._apply_one = counted
    fx_run(sched, agent.start())

    async def rogue():
        t = dst_db.create_transaction()
        t.set(b"rogue", b"write")
        return await fx_outcome(t.commit())

    locked = fx_run(sched, rogue())
    if locked != ("err", "DestinationLockedError"):
        fail(f"features DR: a plain write to the destination gave {locked}")
    committed, counts = [], dict(reads=0, updates=0, conflicts=0, gave_up=0)

    insert = fx_inserter(src_db, keys, values, committed)
    w0, v0 = time.perf_counter(), sched.now()
    fx_run(sched, fx_load(sched, insert, inputs["insert_order"], FX_LOADERS))
    load = (time.perf_counter() - w0, sched.now() - v0, applies[0])
    w1, v1 = time.perf_counter(), sched.now()
    fx_run(sched, fx_workload(sched, src_db.create_transaction, inputs,
                              clients, ops, keys, committed, counts))
    work = (time.perf_counter() - w1, sched.now() - v1)
    lag = src.tlog.version.get() - agent.caught_up_version
    w2, v2 = time.perf_counter(), sched.now()
    final = fx_run(sched, agent.switchover())
    switch = (time.perf_counter() - w2, sched.now() - v2)
    apply_wall = time.perf_counter() - w0
    if final < max(v for v, _k, _val in committed):
        fail(f"features DR: takeover version {final} below the last "
             "acknowledged commit")
    src_rows = fx_user_rows(src_db, sched)
    dst_rows = fx_user_rows(dst_db, sched)
    if dst_rows != src_rows:
        diff = sorted(set(src_rows) ^ set(dst_rows))[:3]
        fail(f"features DR: the destination's {len(dst_rows)} rows differ "
             f"from the source's {len(src_rows)} at the takeover version "
             f"(keys {diff})")
    want = fx_replay(committed)
    if {k: dst_rows.get(k) for k in want} != want:
        fail("features DR: an acknowledged write does not read back from "
             "the destination")

    async def late():
        t = dst_db.create_transaction()
        t.set(b"after", b"switch")
        return await fx_outcome(t.commit())

    after = fx_run(sched, late())
    if after[0] != "ok":
        fail(f"features DR: the destination refused a write after the "
             f"switchover: {after}")
    snaps = fx_snapshots([src, dst])
    unhandled = fx_stop(sched, [src, dst])
    inserts = records
    return dict(
        parts=dict(results=[locked, final, lag, applies, counts,
                            sorted(committed), after[0]],
                   snapshots=snaps, now=sched.now(), unhandled=unhandled),
        numbers=dict(
            records=records, clients=clients, ops=ops,
            load_wall_s=load[0], load_virtual_s=load[1],
            load_commits_per_s=inserts / load[0],
            applied_in_load=load[2],
            workload_wall_s=work[0], workload_virtual_s=work[1],
            updates=counts["updates"], conflicts=counts["conflicts"],
            workload_commits_per_s=counts["updates"] / work[0],
            apply_txns=applies[0], apply_mutations=applies[1],
            apply_commits_per_s=applies[0] / apply_wall,
            apply_mutations_per_s=applies[1] / apply_wall,
            lag_at_switchover_versions=lag,
            switchover_wall_s=switch[0], switchover_virtual_s=switch[1],
            takeover_version=final, rows=len(dst_rows)),
        clusters=2)


def fx_leg_multiregion(size: dict, device, cfg, seed: int = 19) -> dict:
    """Multi-region failover (cluster/multiregion.py): the primary with
    2 log replicas and 2 satellite logs, a RemoteDC (its own log and 2
    storage servers) fed by the LogRouter while YCSB's load runs, its lag
    sampled every virtual ms; caught up, then the router cut off (a
    partition between the regions) while `updates` more commits are
    acknowledged; the whole primary DC killed; `failover()` replays the
    satellites' suffix. Every acknowledged commit reads back at the
    remote at the takeover version (RPO 0)."""
    from foundationdb_tpu_torch.cluster.multiregion import RemoteDC

    records, updates = size["records"], size["updates"]
    inputs = ycsb_a_inputs(seed, records, 1, 1)
    keys, values = inputs["keys"], inputs["values"]
    sched, cluster, db = fx_open(cfg, device, n_storage=2, n_tlogs=2,
                                 n_satellite_logs=2)
    remote = RemoteDC(sched, cluster.tlog, n_tlogs=1, n_storage=2,
                      storage_boundaries=[b"user%010d" % (records // 2)])
    remote.start()
    committed, lags, loading = [], [], [True]

    async def monitor():
        while loading[0]:
            lags.append(remote.lag())
            await sched.delay(0.001)

    insert = fx_inserter(db, keys, values, committed)
    mon = sched.spawn(monitor(), name="fx-lag")
    w0, v0 = time.perf_counter(), sched.now()
    fx_run(sched, fx_load(sched, insert, inputs["insert_order"], FX_LOADERS))
    load = (time.perf_counter() - w0, sched.now() - v0)
    loading[0] = False
    fx_run(sched, remote.wait_caught_up())
    caught = remote.lag()
    sched.run_until(mon.done)
    if caught or max(lags) > ROLE_WINDOW:
        fail(f"features multi-region: lag {caught} after catching up, "
             f"{max(lags)} at most during the load")
    remote.router._task.cancel()
    remote.router._task = None

    async def more():
        gen = np.random.default_rng(seed + 1)
        for n in gen.integers(0, records, updates).tolist():
            txn = db.create_transaction()
            new = b"upd%08d" % len(committed) + values[n][11:]
            txn.set(keys[n], new)
            await txn.commit()
            committed.append((txn.committed_version, keys[n], new))

    fx_run(sched, more())
    last_acked = max(v for v, _k, _val in committed)
    behind = remote.logs.version.get()
    if behind >= last_acked:
        fail("features multi-region: the remote was not behind when the "
             "primary DC died")
    cluster.tlog.kill_dc()
    w1, v1 = time.perf_counter(), sched.now()
    takeover = fx_run(sched, remote.failover())
    fail_wall = (time.perf_counter() - w1, sched.now() - v1)
    if takeover < last_acked:
        fail(f"features multi-region: takeover {takeover} below the last "
             f"acknowledged commit {last_acked}: RPO > 0")
    want = fx_replay(committed)

    async def read_back():
        return {k: await remote.read_at(k, takeover) for k in want}

    got = fx_run(sched, read_back())
    lost = [k for k, v in want.items() if got[k] != v]
    if lost:
        fail(f"features multi-region: {len(lost)} acknowledged writes not "
             f"at the remote at the takeover version (RPO > 0): {lost[:3]}")
    remote_snaps = [s.snapshot() for s in remote.storages]
    snaps = fx_snapshots([cluster])
    remote.stop()
    unhandled = fx_stop(sched, [cluster])
    return dict(
        parts=dict(results=[caught, max(lags), behind, last_acked, takeover,
                            sorted(committed)],
                   snapshots=[snaps, remote_snaps], now=sched.now(),
                   unhandled=unhandled),
        numbers=dict(records=records, updates=updates,
                     load_wall_s=load[0], load_virtual_s=load[1],
                     load_commits_per_s=records / load[0],
                     max_lag_versions=max(lags),
                     behind_versions=last_acked - behind,
                     failover_wall_s=fail_wall[0],
                     failover_virtual_s=fail_wall[1],
                     takeover_version=takeover, read_back=len(got)),
        clusters=1)


def fx_leg_metacluster(size: dict, device, cfg, seed: int = 19) -> dict:
    """The metacluster (cluster/metacluster.py) over a management
    cluster and two data clusters on one scheduler: `tenants` tenants
    created through it, spread by capacity (half each); each tenant's
    `keys` YCSB records loaded and a workload-A mix run through its
    Tenant handle (the conflict ranges reach each data cluster's
    resolver tenant-prefixed). Every tenant reads back exactly its own
    rows (the replay of its commits), each data cluster holds its
    tenants' rows under the tenant prefix and nothing else, and a delete
    of a non-empty tenant is refused."""
    from foundationdb_tpu_torch.cluster import tenant as T
    from foundationdb_tpu_torch.cluster.metacluster import Metacluster
    from foundationdb_tpu_torch.runtime.flow import Scheduler, all_of

    tenants, nkeys = size["tenants"], size["keys"]
    clients, ops = size["clients"], size["ops"]
    sched = Scheduler(sim=True)
    opened = [fx_open(cfg, device, sched, n_commit_proxies=1, n_storage=2)
              for _ in range(3)]
    (_s, mgmt, mgmt_db), (_s, c1, d1), (_s, c2, d2) = opened
    mc = Metacluster(mgmt_db)
    names = [b"tenant%02d" % t for t in range(tenants)]

    async def setup():
        await mc.register_cluster(b"dc1", d1, capacity=tenants // 2)
        await mc.register_cluster(b"dc2", d2, capacity=tenants // 2)
        placed = [await mc.create_tenant(n) for n in names]
        over = await fx_outcome(mc.create_tenant(b"overflow"))
        return placed, over, [await mc.open_tenant(n) for n in names]

    w0 = time.perf_counter()
    placed, over, handles = fx_run(sched, setup())
    setup_s = time.perf_counter() - w0
    if sorted(placed) != [b"dc1"] * (tenants // 2) + [b"dc2"] * (tenants // 2) \
            or over != ("err", "MetaclusterCapacityExceeded"):
        fail(f"features metacluster: placed {placed}, overflow {over}")
    inputs = [ycsb_a_inputs(seed + t, nkeys, clients, ops)
              for t in range(tenants)]
    committed = [[] for _ in range(tenants)]
    counts = dict(reads=0, updates=0, conflicts=0, gave_up=0)

    async def load():
        tasks = [sched.spawn(fx_load(sched, fx_inserter(
            handles[t], inputs[t]["keys"], inputs[t]["values"], committed[t],
            tenant=True),
                                     inputs[t]["insert_order"],
                                     FX_LOADERS // tenants),
                             name=f"fx-tload{t}") for t in range(tenants)]
        await all_of([t.done for t in tasks])

    w1, v1 = time.perf_counter(), sched.now()
    fx_run(sched, load())
    load_s = (time.perf_counter() - w1, sched.now() - v1)

    async def work():
        tasks = [sched.spawn(fx_workload(
            sched, handles[t].create_transaction, inputs[t], clients, ops,
            inputs[t]["keys"], committed[t], counts, tenant=True),
            name=f"fx-twork{t}") for t in range(tenants)]
        await all_of([t.done for t in tasks])

    w2, v2 = time.perf_counter(), sched.now()
    fx_run(sched, work())
    work_s = (time.perf_counter() - w2, sched.now() - v2)

    async def check():
        rows = [await h.create_transaction().get_range(b"", b"\xff")
                for h in handles]
        raw = [await d.create_transaction().get_range(b"", b"\xff")
               for d in (d1, d2)]
        refused = await fx_outcome(mc.delete_tenant(names[0]))
        return rows, raw, refused, await mc.list_tenants()

    rows, raw, refused, assigned = fx_run(sched, check())
    for t in range(tenants):
        if dict(rows[t]) != fx_replay(committed[t]):
            fail(f"features metacluster: tenant {t} does not read back "
                 "exactly its own rows")
    for n, data in enumerate(raw):
        if len(data) != nkeys * tenants // 2 or not all(
                k.startswith(T.TENANT_DATA_PREFIX) for k, _ in data):
            fail(f"features metacluster: data cluster {n + 1} holds "
                 f"{len(data)} rows, not its tenants' {nkeys * tenants // 2}"
                 " under the tenant prefix")
    if refused != ("err", "TenantNotEmpty"):
        fail(f"features metacluster: deleting a non-empty tenant gave "
             f"{refused}")
    clusters = [mgmt, c1, c2]
    snaps = fx_snapshots(clusters)
    unhandled = fx_stop(sched, clusters)
    return dict(
        parts=dict(results=[placed, over, refused, assigned, counts,
                            [sorted(c) for c in committed]],
                   snapshots=snaps, now=sched.now(), unhandled=unhandled),
        numbers=dict(tenants=tenants, keys=nkeys, clients=clients, ops=ops,
                     setup_wall_s=setup_s,
                     load_wall_s=load_s[0], load_virtual_s=load_s[1],
                     load_commits_per_s=tenants * nkeys / load_s[0],
                     workload_wall_s=work_s[0], workload_virtual_s=work_s[1],
                     updates=counts["updates"], conflicts=counts["conflicts"],
                     workload_commits_per_s=counts["updates"] / work_s[0]),
        clusters=3)


def fx_leg_backup(size: dict, device, cfg, seed: int = 19) -> dict:
    """Backup, parallel restore and granules: a `sim_cluster_config`
    source with a BlobWorker and BlobManager tailing its stream over its
    first `granule_records` records from version 0; YCSB's load, a
    BackupAgent snapshot into a BlobStoreContainer served by
    `serve_blob_store` on 127.0.0.1, the log backup through workload A;
    ParallelRestore at 4 appliers into a fresh cluster, whose rows equal
    the source's; the granules' reads (`BlobManager.read`) equal the
    storage's at the loaded version and at the end."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.cluster.backup import (BackupAgent,
                                                       BackupContainer)
    from foundationdb_tpu_torch.cluster.blob_granules import (BlobManager,
                                                              BlobWorker)
    from foundationdb_tpu_torch.cluster.blob_store import (BlobStoreContainer,
                                                           serve_blob_store)
    from foundationdb_tpu_torch.cluster.database import open_cluster
    from foundationdb_tpu_torch.cluster.restore import ParallelRestore
    from foundationdb_tpu_torch.runtime.flow import Scheduler

    records, clients, ops = size["records"], size["clients"], size["ops"]
    inputs = ycsb_a_inputs(seed, records, clients, ops)
    keys, values = inputs["keys"], inputs["values"]
    sched = Scheduler(sim=True)
    _s, src, db = open_cluster(
        sim_cluster_config(records, "cuda", device, cfg), sched=sched)
    granules = BackupContainer()
    worker = BlobWorker(sched, src.tlog, granules, name="blobworker0")
    worker.start()
    mgr = BlobManager(db, [worker])
    gb, ge = keys[0], keys[size["granule_records"]]
    fx_run(sched, mgr.blobbify(gb, ge, {}, 0))
    tmp = tempfile.mkdtemp(prefix="fx-blob")
    srv, port = serve_blob_store(os.path.join(tmp, "objs"))
    cont = BlobStoreContainer(f"127.0.0.1:{port}")
    try:
        agent = BackupAgent(db, cont)
        committed = []
        counts = dict(reads=0, updates=0, conflicts=0, gave_up=0)

        insert = fx_inserter(db, keys, values, committed)
        w0, v0 = time.perf_counter(), sched.now()
        fx_run(sched, fx_load(sched, insert, inputs["insert_order"],
                              FX_LOADERS))
        load = (time.perf_counter() - w0, sched.now() - v0)
        w1 = time.perf_counter()
        snap_version = fx_run(sched, agent.snapshot())
        snap_s = time.perf_counter() - w1
        agent.start_log_backup(src)
        fx_run(sched, fx_workload(sched, db.create_transaction, inputs,
                                  clients, ops, keys, committed, counts))
        sched.run_for(0.3)
        agent.stop_log_backup()
        src_rows = fx_user_rows(db, sched)
        if src_rows != fx_replay(committed):
            fail("features backup: the source's rows are not the replay of "
                 "its commits")
        _s, dst, dst_db = open_cluster(
            sim_cluster_config(records, "cuda", device, cfg), sched=sched)
        w2, v2 = time.perf_counter(), sched.now()
        stats = fx_run(sched, ParallelRestore(dst_db, cont,
                                              n_appliers=4).run())
        restore = (time.perf_counter() - w2, sched.now() - v2)
        dst_rows = fx_user_rows(dst_db, sched)
        if dst_rows != src_rows or stats.appliers != 4:
            fail(f"features backup: the restored {len(dst_rows)} rows "
                 f"({stats}) differ from the source's {len(src_rows)}")
        files = cont.list_files("")
    finally:
        cont.close()
        srv.shutdown()
        srv.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    load_version = snap_version
    end_version = worker.version

    async def storage_rows(v):
        return dict(await db.read_range(gb, ge, v))

    reads = []
    for v in (load_version, end_version):
        blob = mgr.read(gb, ge, v)
        stored = fx_run(sched, storage_rows(v))
        if blob != stored or not stored:
            fail(f"features granules: the granules' {len(blob)} rows at "
                 f"version {v} differ from the storage's {len(stored)}")
        reads.append(sorted(blob.items()))
    worker.stop()
    clusters = [src, dst]
    snaps = fx_snapshots(clusters)
    unhandled = fx_stop(sched, clusters)
    return dict(
        parts=dict(results=[snap_version, stats, counts, sorted(committed),
                            files, reads,
                            sorted((g.gid, g.begin, g.end)
                                   for g in mgr.granules.values())],
                   snapshots=snaps, now=sched.now(), unhandled=unhandled),
        numbers=dict(records=records, clients=clients, ops=ops,
                     load_wall_s=load[0], load_virtual_s=load[1],
                     load_commits_per_s=records / load[0],
                     snapshot_wall_s=snap_s, backup_files=len(files),
                     updates=counts["updates"],
                     restore_wall_s=restore[0], restore_virtual_s=restore[1],
                     restored_rows=len(dst_rows),
                     mutations_applied=stats.mutations_applied,
                     granules=len(mgr.granules),
                     granule_records=size["granule_records"]),
        clusters=2)


def fx_leg_layers(size: dict, device, cfg, seed: int = 19) -> dict:
    """The layers and the cli on one cluster: a HighContentionAllocator
    under `hca_clients` concurrent clients (each its own seeded rng),
    every prefix distinct; a TaskBucket of `tasks` tasks drained by
    `executors` executors, each task run exactly once; then CliSession's
    status, writemode, set, get, tenant, backup and restore."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.cli import CliSession
    from foundationdb_tpu_torch.cluster.commit_proxy import NotCommitted
    from foundationdb_tpu_torch.layers.directory import (
        HighContentionAllocator)
    from foundationdb_tpu_torch.layers.taskbucket import TaskBucket
    from foundationdb_tpu_torch.runtime.flow import all_of

    # one proxy and one resolver: the bucket's claims serialize on its
    # first available task, so each claim is a batch of its own and a
    # second proxy would double the (mostly empty) batches a task
    sched, cluster, db = fx_open(cfg, device, n_storage=2)
    allocated, conflicts = [], [0]

    async def hca_client(c):
        hca = HighContentionAllocator(np.random.default_rng(seed * 100 + c))
        for _ in range(size["hca_each"]):
            while True:
                txn = db.create_transaction()
                n = await hca.allocate(txn)
                try:
                    await txn.commit()
                    allocated.append(n)
                    break
                except NotCommitted:
                    conflicts[0] += 1

    async def hca():
        tasks = [sched.spawn(hca_client(c), name=f"fx-hca{c}")
                 for c in range(size["hca_clients"])]
        await all_of([t.done for t in tasks])

    w0 = time.perf_counter()
    fx_run(sched, hca())
    hca_s = time.perf_counter() - w0
    want = size["hca_clients"] * size["hca_each"]
    if len(allocated) != want or len(set(allocated)) != want:
        fail(f"features layers: the HCA handed out {len(set(allocated))} "
             f"distinct prefixes of {len(allocated)}, not {want}")
    tb = TaskBucket(db)
    names = [b"task%05d" % i for i in range(size["tasks"])]
    ran = []

    async def add(share):
        for k in share:
            await tb.add(k, {"n": k.decode()})

    async def executor():
        while True:
            t = await tb.get_one()
            if t is None:
                return
            ran.append(t.key)
            await tb.finish(t)

    async def bucket():
        adders = [sched.spawn(add(names[a::8]), name=f"fx-add{a}")
                  for a in range(8)]
        await all_of([t.done for t in adders])
        execs = [sched.spawn(executor(), name=f"fx-exec{e}")
                 for e in range(size["executors"])]
        await all_of([t.done for t in execs])
        return await tb.is_empty()

    w1 = time.perf_counter()
    empty = fx_run(sched, bucket())
    tb_s = time.perf_counter() - w1
    if sorted(ran) != names or not empty:
        fail(f"features layers: the TaskBucket ran {len(ran)} tasks "
             f"({len(set(ran))} distinct) of {len(names)}, empty {empty}")
    cli = CliSession(cluster, db)
    tmp = tempfile.mkdtemp(prefix="fx-cli")
    cmds = ["status", "writemode on", "set fx/cli alive", "get fx/cli",
            "tenant create fxcli", "tenant list", f"backup {tmp}/bk",
            "clear fx/cli", "get fx/cli", f"restore {tmp}/bk", "get fx/cli"]

    async def session():
        return [await cli.run_command(c) for c in cmds]

    w2 = time.perf_counter()
    try:
        out = fx_run(sched, session())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cli_s = time.perf_counter() - w2
    if ("resolver_backend    - cuda" not in out[0] or out[2] != "Committed"
            or out[3] != "`fx/cli' is `alive'" or out[5] != "fxcli"
            or not out[6].startswith("Snapshot complete")
            or out[8] != "`fx/cli': not found"
            or not out[9].startswith("Restored") or out[10] != out[3]):
        fail(f"features cli: {out}")
    snaps = fx_snapshots([cluster])
    unhandled = fx_stop(sched, [cluster])
    return dict(
        parts=dict(results=[allocated, conflicts[0], ran, out],
                   snapshots=snaps, now=sched.now(), unhandled=unhandled),
        numbers=dict(hca_allocations=want, hca_conflicts=conflicts[0],
                     hca_wall_s=hca_s, tasks=len(names), taskbucket_wall_s=tb_s,
                     tasks_per_s=len(names) / tb_s, cli_wall_s=cli_s),
        clusters=1)


FX_LEGS = {"dr": fx_leg_dr, "multiregion": fx_leg_multiregion,
           "metacluster": fx_leg_metacluster, "backup": fx_leg_backup,
           "layers": fx_leg_layers}


def fx_call(leg: str, size: dict, device, cfg) -> dict:
    """One leg on `device`, its probes hit (the port's registry, counted
    over the run) with its parts; fails on an unhandled actor error."""
    from foundationdb_tpu_torch.utils import probes

    before = probes.snapshot()
    out = (FX_LEGS.get(leg) or SE_LEGS[leg])(size, device, cfg)
    after = probes.snapshot()
    # the wall clock's watchdog is not the schedule's
    out["parts"]["probes"] = {
        n: c - before.get(n, 0) for n, c in sorted(after.items())
        if c - before.get(n, 0) and n != "runtime.slow_task"}
    if out["parts"]["unhandled"]:
        fail(f"features {leg}: unhandled actor errors "
             f"{out['parts']['unhandled'][:5]}")
    return out


def fx_twin(leg: str):
    """A leg's twin with the plain versions, in a worker process (one
    torch thread, no CUDA): its digest and wall."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = fx_call(leg, FX_TWIN[leg], "cpu", fx_twin_config())
    return fx_digest(out["parts"]), time.perf_counter() - t0


def fx_on_card(tag: str, leg: str, size: dict, cfg, device,
               twin: bool) -> dict:
    """One leg on `device` (the card when None) with the launch counts
    from 0 and every port Resolver it builds recorded; fails unless each
    is a TorchConflictSet on that device. Returns the digest (a twin's
    only: a full-size run's snapshots are hundreds of MB), the numbers,
    the wall, the launches, the resolvers' batches and compactions and
    the device memory's peak."""
    import gc

    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.resolver import Resolver

    built = []
    init = Resolver.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    on = "cuda" if device is None else str(device)
    Resolver.__init__ = record
    if on == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        out = fx_call(leg, size, device, cfg)
    finally:
        Resolver.__init__ = init
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.counts().items() if n}
    en_resolvers_kernels(f"features {tag}", built, on)
    res = dict(digest=fx_digest(out["parts"]) if twin else None,
               numbers=out["numbers"],
               wall_s=wall, launches=launches, resolvers=len(built),
               batches=sum(r.conflict_set.metrics.counters.get(
                   "resolveBatches") for r in built),
               compactions=sum(r.conflict_set.metrics.counters.get(
                   "compactions") for r in built),
               probes=sorted(out["parts"]["probes"]))
    built.clear()
    out.clear()
    gc.collect()
    res["memory_peak"] = (torch.cuda.max_memory_allocated()
                          if on == "cuda" else 0)
    return res


def fx_card_worker(legs: tuple, device) -> dict:
    """In a spawned process with its own CUDA context: each leg's twin,
    then the leg at full size, through `fx_on_card`."""
    runs = {}
    for leg in legs:
        runs[f"{leg} twin"] = fx_on_card(f"{leg} twin", leg, FX_TWIN[leg],
                                         fx_twin_config(), device, True)
        runs[leg] = fx_on_card(leg, leg, FX_FULL[leg], commit_config(),
                               device, False)
    return runs


def phase_features(card: str, uniform: dict, device=None) -> dict:
    """The features beside the commit path on the card (cell FX): the
    five legs of FX_LEGS (DR, multi-region failover, the metacluster and
    its tenants, backup + parallel restore + granules, the layers and
    the cli), each at its twin size (FX_TWIN, `fx_twin_config()`) and at
    full size (FX_FULL, `commit_config()`), every resolver a
    TorchConflictSet on the card, in the FX_CARD_WORKERS spawned
    processes; meanwhile FX_WORKERS more run each twin with
    device="cpu". It fails on any leg's own check, unless each card
    twin's digest (results, every storage snapshot, the virtual time,
    the unhandled errors, the probes hit) equals its plain-version
    twin's, unless each run's launches are phase 3's chain a batch
    (`tiered_launch_want`: A's counts and probe, L and N phase 3's count
    a batch over all its resolvers' batches, D one more a compaction),
    and unless the whole takes at most FX_BUDGET_S."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    twin_pool = ProcessPoolExecutor(max_workers=FX_WORKERS, mp_context=ctx)
    card_pool = ProcessPoolExecutor(max_workers=len(FX_CARD_WORKERS),
                                    mp_context=ctx)
    try:
        twins = {leg: twin_pool.submit(fx_twin, leg) for leg in FX_LEGS}
        on_card = [card_pool.submit(fx_card_worker, legs, device)
                   for legs in FX_CARD_WORKERS]
        runs = {}
        for f in on_card:
            runs.update(f.result())
        t_twins = time.perf_counter()
        twin = {leg: f.result() for leg, f in twins.items()}
        twin_wait = time.perf_counter() - t_twins
    finally:
        card_pool.shutdown(wait=True, cancel_futures=True)
        twin_pool.shutdown(wait=True, cancel_futures=True)
    for leg in FX_LEGS:
        got, want = runs[f"{leg} twin"]["digest"], twin[leg][0]
        bad = sorted(k for k in want if got.get(k) != want[k])
        if bad or set(got) != set(want):
            fail(f"features {leg}: the card's twin differs from the plain "
                 f"versions' in {bad or sorted(set(got) ^ set(want))}")
    for tag, run in runs.items():
        for k, n in tiered_launch_want(uniform, run["batches"],
                                       run["compactions"]).items():
            if run["launches"].get(k, 0) != n:
                fail(f"features {tag}: {k} launched "
                     f"{run['launches'].get(k, 0)} times in {run['batches']}"
                     f" batches ({run['compactions']} compactions), not {n}")
    wall_s = time.perf_counter() - t_phase
    out = dict(card=card, phase_wall_s=wall_s, twin_wait_s=twin_wait,
               runs={})
    for tag, run in runs.items():
        leg = tag.removesuffix(" twin")
        row = dict(wall_s=run["wall_s"], resolvers=run["resolvers"],
                   batches=run["batches"], compactions=run["compactions"],
                   launches=run["launches"],
                   launches_per_batch={k: n / max(run["batches"], 1)
                                       for k, n in run["launches"].items()},
                   memory_peak=run["memory_peak"], probes=run["probes"],
                   **run["numbers"])
        if tag != leg:
            row["plain_wall_s"] = twin[leg][1]
        out["runs"][tag] = row
        nums = ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                         else f"{k} {v}" for k, v in run["numbers"].items())
        log(f"  {tag}: {run['wall_s']:.2f} s on the card"
            + (f" (plain versions {twin[leg][1]:.2f} s, digest equal)"
               if tag != leg else "")
            + f"; {nums}; {run['resolvers']} resolvers, {run['batches']} "
            f"batches ({run['compactions']} compactions), launches a batch "
            f"{json.dumps({k: round(v, 3) for k, v in row['launches_per_batch'].items()})}"
            f"; device memory peak {run['memory_peak']} bytes; on {card}")
    log(f"  every twin's digest equal to the plain versions' (results, "
        f"storage snapshots, virtual time, probes hit), every resolver a "
        f"TorchConflictSet on the card with phase 3's launches a batch; "
        f"waited {twin_wait:.2f} s for the twins; phase wall {wall_s:.1f} s "
        f"of the {FX_BUDGET_S:.0f} s budget; on {card}")
    if wall_s > FX_BUDGET_S:
        fail(f"features: the phase took {wall_s:.1f} s, over its "
             f"{FX_BUDGET_S:.0f} s budget")
    return out


# ---------------------------------------------------------------------------
# phase 20: the sealed commit path over mutual TLS, tenant tokens

#: the phase's wall budget (both legs); it fails past twice that (a hang,
#: not the host's pace, which varies up to 1.5x between calls)
SE_BUDGET_S = 150.0
#: loaded values the disk scan looks for, besides the sentinel
SE_SAMPLES = 64
SE_SENTINEL_KEY = b"se/sentinel"
SE_SENTINEL = b"SE-SENTINEL-PLAINTEXT-VALUE-" + bytes(range(65, 101))
#: leg B at full size (the card, `commit_config()`) and at its twin size
#: (FX's metacluster twin's 50 keys a tenant, `fx_twin_config()`) on the
#: card and on the plain versions; the tenants and the denials are the
#: same at both sizes, so their decision counts must be too
SE_AUTHZ_FULL = dict(tenants=8, records=1_000)
SE_AUTHZ_TWIN = dict(tenants=8, records=50)
#: the short-lived token's life, virtual seconds
SE_TOKEN_LIFE = 0.01
#: the kinds of token leg B's denials present, each to every tenant
SE_DENIALS = ("missing", "other tenant", "forged", "expired", "malformed")


def sealed_disk_checks(label: str, data_dirs: dict, samples: list) -> dict:
    """The at-rest guarantee on the raw files of stopped sealed roles: no
    file under either data dir holds the sentinel or a sampled loaded
    value (tests/test_encrypted_storage.py's scan), each dir has its
    ENCRYPTION_MODE marker, and a StorageRole and a TLogRole opened there
    without encryption raise the marker's RuntimeError."""
    from foundationdb_tpu_torch.cluster import multiprocess as mp

    t0 = time.perf_counter()
    needles = [SE_SENTINEL] + list(samples)
    files = scanned = 0
    for name, d in data_dirs.items():
        if not os.path.exists(os.path.join(d, "ENCRYPTION_MODE")):
            fail(f"{label}: the {name} data dir has no ENCRYPTION_MODE "
                 "marker")
        for root, _dirs, names in os.walk(d):
            for f in names:
                with open(os.path.join(root, f), "rb") as fh:
                    data = fh.read()
                files += 1
                scanned += len(data)
                for i, needle in enumerate(needles):
                    if needle in data:
                        fail(f"{label}: {'the sentinel' if i == 0 else 'a loaded value'}"
                             f" is in plaintext in {name}'s {f}")
    for name, make in (("storage", mp.StorageRole), ("tlog", mp.TLogRole)):
        try:
            make(data_dir=data_dirs[name])
        except RuntimeError as e:
            if "encryption" not in str(e):
                raise
        else:
            fail(f"{label}: the sealed {name} dir opened without "
                 "encryption")
    return dict(files=files, bytes=scanned, needles=len(needles),
                scan_s=time.perf_counter() - t0, mode_flip_refused=True)


def killed_checks(label: str, killed: dict, encrypt: bool, out: dict) -> None:
    """The storage child started again after its SIGKILL: its snapshot at
    the last acknowledged version is the replay of the commits by then,
    and, sealed, it fetched its keys from the KMS (the two it seals new
    records under and the two, by id, that the old records name) and
    opened every value it served."""
    want = fx_replay(killed["committed"])
    snap = killed["snapshot"]
    if snap.version < killed["head"] or snap.kvs != sorted(want.items()):
        fail(f"{label}: the restarted storage's snapshot at "
             f"{killed['head']} ({len(snap.kvs)} keys) is not the replay of "
             f"{len(killed['committed'])} commits")
    row = dict(head=killed["head"], keys=len(snap.kvs),
               restart_to_first_answer_s=killed["restart_s"],
               snapshot_s=killed["snapshot_s"])
    if encrypt:
        enc = killed["after"]["encryption"]
        if enc["kms_fetches"] < 4 or enc["opens"] != len(snap.kvs):
            fail(f"{label}: the restarted storage fetched {enc['kms_fetches']}"
                 f" keys and opened {enc['opens']} values for a snapshot of "
                 f"{len(snap.kvs)}")
        row.update(kms_fetches=enc["kms_fetches"], opens=enc["opens"],
                   open_us_per_value=enc["open_seconds"] / enc["opens"] * 1e6)
    out["kill"] = row


def se_sign_raw(private_key, payload: bytes) -> bytes:
    """A token over an arbitrary payload, validly signed (a faulty
    identity provider's: the claims are malformed)."""
    import base64

    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec

    sig = private_key.sign(payload, ec.ECDSA(hashes.SHA256()))
    return base64.b64encode(payload) + b"." + base64.b64encode(sig)


def se_leg_authz(size: dict, device, cfg, seed: int = 21) -> dict:
    """Tenant tokens on `open_cluster` (cluster/tenant.py with a
    crypto/token_sign TokenVerifier on `cluster.token_verifier`):
    `tenants` tenants, each loading `records` YCSB records through its
    Tenant handle under its own signed token. Then, to each tenant, a
    short-lived token allowed before its expiry, and the denials of
    SE_DENIALS (no token, another tenant's, one signed by an untrusted
    key under the trusted key id, the short-lived one after its expiry on
    the scheduler's clock, one validly signed over malformed claims),
    each a write that must raise PermissionDeniedError. Every tenant
    reads back exactly its own rows under its token (the replay of its
    loads: no denied write landed), and the tenant data holds tenants x
    records rows."""
    import json as _json

    from foundationdb_tpu_torch.cluster import tenant as T
    from foundationdb_tpu_torch.crypto import token_sign as TS
    from foundationdb_tpu_torch.runtime.flow import all_of

    tenants, records = size["tenants"], size["records"]
    sched, cluster, db = fx_open(cfg, device, n_commit_proxies=1,
                                 n_storage=2)
    key, pub = TS.generate_keypair()
    rogue, _ = TS.generate_keypair()
    cluster.token_verifier = TS.TokenVerifier({"idp": pub})
    names = [b"tenant%02d" % t for t in range(tenants)]

    async def setup():
        for n in names:
            await T.create_tenant(db, n)

    fx_run(sched, setup())
    tokens = {n: TS.sign_token(key, tenants=[n], expires_at=sched.now()
                               + 3600.0, key_id="idp") for n in names}
    handles = [T.Tenant(db, n, token=tokens[n]) for n in names]
    inputs = [ycsb_a_inputs(seed + t, records, 1, 1) for t in range(tenants)]
    committed = [[] for _ in range(tenants)]

    async def load():
        tasks = [sched.spawn(fx_load(sched, fx_inserter(
            handles[t], inputs[t]["keys"], inputs[t]["values"], committed[t],
            tenant=True), inputs[t]["insert_order"], FX_LOADERS // tenants),
                             name=f"se-load{t}") for t in range(tenants)]
        await all_of([t.done for t in tasks])

    w0, v0 = time.perf_counter(), sched.now()
    fx_run(sched, load())
    load_s = (time.perf_counter() - w0, sched.now() - v0)

    async def write_denied(txn):
        await txn.set(b"se/denied", b"denied")

    async def denials():
        outcomes = {k: [] for k in ("brief before expiry",) + SE_DENIALS}
        for t, n in enumerate(names):
            brief = TS.sign_token(key, tenants=[n], key_id="idp",
                                  expires_at=sched.now() + SE_TOKEN_LIFE)

            async def read_brief():
                return await T.Tenant(db, n, token=brief).create_transaction(
                ).get(inputs[t]["keys"][0])

            outcomes["brief before expiry"].append(
                await fx_outcome(read_brief()))
            await sched.delay(2 * SE_TOKEN_LIFE)
            bad = {
                "missing": None,
                "other tenant": tokens[names[(t + 1) % tenants]],
                "forged": TS.sign_token(rogue, tenants=[n], key_id="idp",
                                        expires_at=sched.now() + 3600.0),
                "expired": brief,
                "malformed": se_sign_raw(key, _json.dumps(
                    {"kid": "idp", "exp": True,
                     "tenants": [n.decode()]}).encode()),
            }
            for kind in SE_DENIALS:
                outcomes[kind].append(await fx_outcome(
                    T.Tenant(db, n, token=bad[kind]).run(write_denied)))
        rows = [dict(await h.create_transaction().get_range(b"", b"\xff"))
                for h in handles]
        raw = await db.create_transaction().get_range(
            T.TENANT_DATA_PREFIX, T.TENANT_DATA_PREFIX + b"\xff")
        return outcomes, rows, len(raw)

    w1 = time.perf_counter()
    outcomes, rows, n_raw = fx_run(sched, denials())
    deny_s = time.perf_counter() - w1
    for t in range(tenants):
        if rows[t] != fx_replay(committed[t]):
            fail(f"sealed authz: tenant {t} does not read back exactly its "
                 f"own {records} rows")
    if n_raw != tenants * records:
        fail(f"sealed authz: the tenant data holds {n_raw} rows, not "
             f"{tenants * records}")
    decisions = {"allowed": 0, "denied": {}}
    for kind, got in outcomes.items():
        if kind == "brief before expiry":
            ok = [o for o in got if o[0] == "ok" and o[1] is not None]
            if len(ok) != tenants:
                fail(f"sealed authz: the short-lived tokens before expiry "
                     f"gave {got[:3]}")
            decisions["allowed"] += len(ok)
            continue
        denied = [o for o in got if o == ("err", "PermissionDeniedError")]
        if len(denied) != tenants:
            fail(f"sealed authz: the {kind} tokens gave {got[:3]}, not "
                 "PermissionDeniedError")
        decisions["denied"][kind] = len(denied)
    # own tokens: one grant a tenant for its read-back (its loads ran
    # under it too); ECDSA verifies: each distinct token once
    decisions["allowed"] += tenants
    decisions["verifies"] = cluster.token_verifier.verifies
    snaps = fx_snapshots([cluster])
    unhandled = fx_stop(sched, [cluster])
    return dict(
        parts=dict(results=[decisions, outcomes,
                            [sorted(c) for c in committed]],
                   snapshots=snaps, now=sched.now(), unhandled=unhandled),
        numbers=dict(tenants=tenants, records=records,
                     load_wall_s=load_s[0], load_virtual_s=load_s[1],
                     load_commits_per_s=tenants * records / load_s[0],
                     denials_wall_s=deny_s, decisions=decisions),
        clusters=1)


#: phase 20's legs run through fx_call and fx_on_card beside FX's
SE_LEGS = {"authz": se_leg_authz}


def se_authz_on_card(device) -> dict:
    """In a spawned process with its own CUDA context: leg B at its full
    size and at its twin size on the card (`fx_on_card`)."""
    return {"full": fx_on_card("sealed authz", "authz", SE_AUTHZ_FULL,
                               commit_config(), device, False),
            "twin": fx_on_card("sealed authz twin", "authz", SE_AUTHZ_TWIN,
                               fx_twin_config(), device, True)}


def se_authz_plain() -> tuple:
    """In a spawned process, one torch thread: leg B at its twin size on
    the plain versions; its digest, decisions and wall."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = fx_call("authz", SE_AUTHZ_TWIN, "cpu", fx_twin_config())
    return (fx_digest(out["parts"]), out["numbers"]["decisions"],
            time.perf_counter() - t0)


def phase_sealed(card: str, uniform: dict, commit: dict) -> dict:
    """Cell SE. Leg A: phase 15's commit path (`phase_commit_path`) with
    the tlog and the storage sealed, their keys from the port's stub REST
    KMS (`cluster/kms.serve_stub_kms` on 127.0.0.1, named to the children
    by FDB_TPU_KMS), every connection of the parent and the children
    mutual TLS under a PKI from the port's `crypto/tls.make_test_tls`
    (FDB_TPU_TLS_DIR), and the storage killed with SIGKILL at half of
    workload A and started again. It keeps phase 15's checks (the
    oracle's replies, the replay, phase 3's chain of launches) and adds
    the raw disk scan, the restart's replay and by-id key fetches, the
    refused mode flip, a plaintext client refused, every parent
    connection a TLS handshake with the peer's certificate, and the stub
    KMS's requests equal to the children's fetches. Leg B: tenant tokens
    (`se_leg_authz`) at SE_AUTHZ_FULL on the card, and at SE_AUTHZ_TWIN
    on the card and on the plain versions: the twins' digests equal, the
    decision counts at both sizes equal, phase 3's chain a batch. Leg B
    runs in two spawned processes (the card's and the plain versions')
    while leg A runs here. The parent's environment is restored on the
    way out; the phase's wall is held against SE_BUDGET_S, and it fails
    past twice that."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from foundationdb_tpu_torch.cluster.kms import serve_stub_kms
    from foundationdb_tpu_torch.crypto.tls import make_test_tls
    from foundationdb_tpu_torch.wire import transport

    t_phase = time.perf_counter()
    # leg B first, in spawned processes started before the environment
    # below is set
    pool = ProcessPoolExecutor(max_workers=2,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        leg_b = (pool.submit(se_authz_on_card, None),
                 pool.submit(se_authz_plain))
        sealed = se_leg_a(card, uniform)
        authz, (plain_digest, want, plain_s) = (f.result() for f in leg_b)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    w, c = sealed["workload"], commit["workload"]
    seals, opens = sealed["storage_seals"], sealed["storage_opens"]
    log(f"  leg A: load {sealed['load']['commits_per_s']:.1f} commits/s "
        f"(phase 15 {commit['load']['commits_per_s']:.1f}), workload "
        f"{w['commits_per_s']:.1f} (phase 15 {c['commits_per_s']:.1f}); "
        f"commit p50 {w['commit_p50_ms']:.3f} / p99 {w['commit_p99_ms']:.3f}"
        f" ms (phase 15 {c['commit_p50_ms']:.3f} / {c['commit_p99_ms']:.3f})"
        f", read p50 {w['read_p50_ms']:.3f} ms (phase 15 "
        f"{c['read_p50_ms']:.3f}); on {card}")
    log(f"  leg A: the storage child sealed {seals} values at "
        f"{sealed['seal_us_per_record']['storage']:.2f} us and opened "
        f"{opens} at {sealed['open_us_per_record']['storage']:.2f} us a "
        f"record, the tlog sealed {sealed['tlog_seals']} records at "
        f"{sealed['seal_us_per_record']['tlog']:.2f} us; "
        f"{sealed['tls']['handshakes']} TLS handshakes in the parent "
        f"({sealed['tls']['versions']}, {sealed['tls']['ciphers']}), a "
        f"plaintext client refused; {sealed['kms_requests']} stub KMS "
        f"requests; on {card}")
    k, a = sealed["kill"], sealed["at_rest"]
    log(f"  leg A: SIGKILL of the storage at half of workload A (head "
        f"{k['head']}): up again in {k['restart_to_first_answer_s']:.2f} s, "
        f"its snapshot of {k['keys']} keys the replay ({k['snapshot_s']:.2f}"
        f" s, {k['kms_fetches']} KMS fetches, {k['opens']} values opened at "
        f"{k['open_us_per_value']:.2f} us); {a['files']} files, "
        f"{a['bytes']} bytes scanned for {a['needles']} plaintexts, none "
        f"found ({a['scan_s']:.2f} s); the mode flip refused; on {card}")
    if authz["twin"]["digest"] != plain_digest:
        fail("sealed authz: the card's twin differs from the plain versions'")
    for tag, run in authz.items():
        if run["numbers"]["decisions"] != want:
            fail(f"sealed authz {tag}: decisions {run['numbers']['decisions']}"
                 f" differ from the plain versions' {want}")
        for kern, n in tiered_launch_want(uniform, run["batches"],
                                          run["compactions"]).items():
            if run["launches"].get(kern, 0) != n:
                fail(f"sealed authz {tag}: {kern} launched "
                     f"{run['launches'].get(kern, 0)} times in "
                     f"{run['batches']} batches, not {n}")
    full = authz["full"]
    log(f"  leg B: {SE_AUTHZ_FULL['tenants']} tenants x "
        f"{SE_AUTHZ_FULL['records']} records under their tokens in "
        f"{full['numbers']['load_wall_s']:.2f} s "
        f"({full['numbers']['load_commits_per_s']:.1f} commits/s); "
        f"decisions {json.dumps(want)} on the card and on the plain versions"
        f" (twin {authz['twin']['wall_s']:.2f} s on the card, {plain_s:.2f} s"
        f" plain, digests equal); {full['batches']} batches, launches a "
        f"batch {json.dumps({k: round(n / max(full['batches'], 1), 3) for k, n in full['launches'].items()})}"
        f"; on {card}")
    wall = time.perf_counter() - t_phase
    log(f"  phase wall {wall:.1f} s, "
        f"{'within' if wall <= SE_BUDGET_S else 'over'} its "
        f"{SE_BUDGET_S:.0f} s budget; on {card}")
    if wall > 2 * SE_BUDGET_S:
        fail(f"sealed: the phase took {wall:.1f} s, over twice its "
             f"{SE_BUDGET_S:.0f} s budget")
    return dict(card=card, phase_wall_s=wall,
                within_budget=wall <= SE_BUDGET_S, commit_path=sealed,
                phase15=dict(load=commit["load"], workload=commit["workload"]),
                authz={tag: dict(wall_s=r["wall_s"], batches=r["batches"],
                                 compactions=r["compactions"],
                                 launches=r["launches"],
                                 memory_peak=r["memory_peak"],
                                 **r["numbers"])
                       for tag, r in authz.items()},
                authz_plain_wall_s=plain_s)


def se_leg_a(card: str, uniform: dict) -> dict:
    """Phase 20's leg A (see phase_sealed): the stub KMS and the PKI set
    up, the environment set for the children and restored after, the
    parent's TLS handshakes and the KMS's requests counted."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.cluster.kms import serve_stub_kms
    from foundationdb_tpu_torch.crypto.tls import make_test_tls
    from foundationdb_tpu_torch.wire import transport

    pki = tempfile.mkdtemp(prefix="fdbpki")
    make_test_tls(pki, names=("node",))
    srv, port = serve_stub_kms()
    handler = srv.RequestHandlerClass
    post, kms_posts = handler.do_POST, [0]

    def counted_post(self):
        kms_posts[0] += 1
        post(self)

    handler.do_POST = counted_post
    connect, handshakes = transport.RpcConnection.connect, []

    async def counted_connect(self, *a, **k):
        await connect(self, *a, **k)
        if self.tls is not None:
            so = self._writer.get_extra_info("ssl_object")
            handshakes.append((so.version(), so.cipher()[0],
                               so.getpeercert(binary_form=True) is not None))

    env = {"FDB_TPU_TLS_DIR": pki, "FDB_TPU_KMS": f"127.0.0.1:{port}"}
    saved = {k: os.environ.get(k) for k in env}
    transport.RpcConnection.connect = counted_connect
    os.environ.update(env)
    try:
        sealed = phase_commit_path(card, encrypt=True, kill_storage=True,
                                   seed=20, label="sealed commit path")
        check_commit_launches(sealed, uniform, card, "sealed commit path")
    finally:
        transport.RpcConnection.connect = connect
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        srv.shutdown()
        srv.server_close()
        shutil.rmtree(pki, ignore_errors=True)
    if not handshakes or not all(h[2] for h in handshakes):
        fail(f"sealed commit path: {len(handshakes)} TLS handshakes, not all "
             "with the peer's certificate")
    seal = sealed.pop("sealing")
    fetches = (seal["tlog"]["kms_fetches"]
               + sum(s["kms_fetches"] for s in seal["storage"]))
    if kms_posts[0] != fetches or fetches < 6:
        fail(f"sealed commit path: the stub KMS answered {kms_posts[0]} "
             f"requests for the children's {fetches} fetches")
    seals = sealed["storage_seals"] = sum(s["seals"] for s in seal["storage"])
    opens = sealed["storage_opens"] = sum(s["opens"] for s in seal["storage"])
    sealed["tlog_seals"] = seal["tlog"]["seals"]
    sealed["tls"] = dict(handshakes=len(handshakes),
                         versions=sorted({h[0] for h in handshakes}),
                         ciphers=sorted({h[1] for h in handshakes}))
    sealed["kms_requests"] = kms_posts[0]
    sealed["seal_us_per_record"] = dict(
        storage=sum(s["seal_seconds"] for s in seal["storage"])
        / max(seals, 1) * 1e6,
        tlog=seal["tlog"]["seal_seconds"] / max(sealed["tlog_seals"], 1)
        * 1e6)
    sealed["open_us_per_record"] = dict(
        storage=sum(s["open_seconds"] for s in seal["storage"])
        / max(opens, 1) * 1e6)
    return sealed


def survey_spans(device, uni) -> tuple:
    """The widest spans of the uniform stream: tiered (each batch against
    the delta tier an exact set holds just before it) and classic
    (groups of 8 against the single tier): (S, the widest spans). S is
    the smallest power of two >= 4 at or above the widest span."""
    from foundationdb_tpu_torch import interop, make_conflict_set
    from foundationdb_tpu_torch.ops.group import span_widths

    widest = {}

    def note(spans):
        for k, v in spans.items():
            widest[k] = max(widest.get(k, 0), v)

    tiered = make_conflict_set(bench_config(B), "cuda")
    for b in uni:
        g = interop.device_args_to_torch(
            groups_of([b])[0], device)
        note(span_widths(tiered.state.delta, g))
        tiered.resolve_packed(b)
    classic = make_conflict_set(bench_config(B, delta_capacity=0), "cuda")
    for stacked in groups_of(uni):
        note(span_widths(classic.state,
                         interop.device_args_to_torch(stacked, device)))
        classic.resolve_group_args(stacked)
    top = max(widest.values())
    return max(4, 1 << max(0, (top - 1).bit_length())), widest


def fixpoint_inputs(gen, batch, device) -> tuple:
    """One uniform batch's short-span fixpoint as the group kernel gives
    kernel K: (leaves, wlo, whi, val, lq_lo, lq_hi), the local ranks of
    the batch's live endpoints (dead writes at [0, 0)) over 2^18 leaves,
    val random txn ids, 5% INT32_POS (uncommitted)."""
    import torch

    from foundationdb_tpu_torch.ops import group as G

    a, rank = local_ranks(batch, device)
    wv = a["write_valid"]
    val = torch.randint(0, B, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    val[torch.rand((B,), generator=gen, device=device) < 0.05] = \
        G.INT32_POS
    return (4 * B, torch.where(wv, rank[2 * B:3 * B], 0),
            torch.where(wv, rank[3 * B:], 0), val, rank[:B],
            rank[B:2 * B])


def fixpoint_cover(fix):
    """The exact fixpoint's min cover of a batch's writes (kernel C):
    what kernel B builds the min table over."""
    from foundationdb_tpu_torch.ops import segtree

    leaves, wlo, whi, val = fix[:4]
    return segtree.min_cover(leaves, wlo, whi, val)


def local_ranks(batch, device) -> tuple:
    """(the batch's torch arguments, the local ranks of its live endpoints
    [rb, re, wb, we], dead rows at the sentinel's): the ranks the group
    kernel's fixpoint works in."""
    import torch

    from foundationdb_tpu_torch import interop
    from foundationdb_tpu_torch.ops import keys as K

    a = interop.device_args_to_torch(batch.device_args(), device)
    live = torch.cat([a["read_valid"], a["read_valid"], a["write_valid"],
                      a["write_valid"]])
    pts = torch.where(live[:, None], torch.cat([
        a["read_begin"], a["read_end"], a["write_begin"], a["write_end"]]),
        K.SENTINEL_WORD).contiguous()
    return a, K.dense_ranks(pts)


def survey_read_spans(device, streams: dict) -> dict:
    """The fixpoint's read spans (local ranks) of every batch of each
    stream: the largest, p50, p99 and the count past 2^L for each L the
    fixpoint may take (FIXPOINT_LEVELS is chosen from these)."""
    import torch

    def spans_of(b):
        a, rank = local_ranks(b, device)
        nr = a["read_valid"].shape[0]
        return (rank[nr:2 * nr] - rank[:nr])[a["read_valid"]]

    out = {}
    for tag, batches in streams.items():
        spans = torch.cat([spans_of(b) for b in batches]).double()
        row = dict(batches=len(batches), reads=int(spans.numel()),
                   max=int(spans.max()), p50=float(spans.quantile(0.5)),
                   p99=float(spans.quantile(0.99)))
        for levels in LEVEL_CHOICES:
            row[f"past_2^{levels}"] = int((spans > (1 << levels)).sum())
        out[tag] = row
        log(f"  read spans, {tag}: {row}")
    return out


def apply_bound(leaves: int, wlo, whi, val, lq_lo, lq_hi, ss: int):
    """(bytes, operations, covered leaves) of one fixpoint application:
    each write's and read's two ranks and the val or the min (12 B each),
    each covered leaf's int32 min written and read back (4 B, twice: what
    the function needs, not the 8 B stamped leaf the kernel moves); a min
    for each leaf a committed write covers and each leaf a read reads."""
    committed = val < 2**31 - 1
    ops = int(((whi - wlo).clamp(0, ss) * committed).sum()
              + (lq_hi - lq_lo).clamp(0, ss).sum())
    n_leaves = covered_leaves(leaves, wlo, whi, val, ss)
    return (12 * (wlo.shape[0] + lq_lo.shape[0]) + 2 * 4 * n_leaves, ops,
            n_leaves)


def phase_short_span(device, uni, ycsb, tiered_ref: dict,
                     classic_ref: dict, sharded_ref: dict) -> dict:
    """short_span_limit = S on the uniform stream: tiered (24 batches),
    classic (3 groups of 8) and 4 shards (1 group), every field and tier
    identical to the same batches at S = 0 on the card, batch or group 0
    to the CPU plain path; kernel K held to its plain version at the
    uniform batch's shapes; a YCSB-E group at S must raise."""
    import torch

    from foundationdb_tpu_torch import (
        HistoryOverflowError,
        interop,
        kernels,
        make_conflict_set,
    )
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import keys as K

    t0 = time.perf_counter()
    ss, widest = survey_spans(device, uni)
    log(f"  widest live spans of the uniform stream {widest} (tiered "
        f"against the delta tier, classic groups of {GROUP} against the "
        f"tier; survey {time.perf_counter() - t0:.1f} s): S = {ss}")

    # kernel K at the uniform batch's shapes: phase (b) over a main tier
    # of the stream's keys, phase (e)'s cover and query in local ranks
    ledger = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(55)
    a = interop.device_args_to_torch(uni[0].device_args(), device)
    sk = torch.unique(torch.randint(0, KEYSPACE, (M,), generator=gen,
                                    device=device))[: 3 * M // 4]
    mkeys = K.sentinel_like(M, W, device)
    mkeys[: sk.shape[0]] = int_keys(sk)
    mver = torch.randint(0, 5_000_000, (M,), generator=gen, device=device,
                         dtype=torch.int32)
    il = K.searchsorted(mkeys, a["read_begin"], side="right") - 1
    ir = K.searchsorted(mkeys, a["read_end"], side="left") - 1
    blo, bhi = il.clamp(min=0), ir + 1
    covered = int((bhi - blo).clamp(0, ss).sum())
    measure(ledger, "short_span.range",
            lambda: G.ss_range(mver, blo, bhi, ss, op="max"),
            lambda: G.ss_range_plain(mver, blo, bhi, ss, op="max"),
            n_bytes=12 * B + 4 * covered, n_ops=covered)
    fix = fixpoint_inputs(gen, uni[0], device)
    n_bytes, n_ops, n_leaves = apply_bound(*fix, ss)
    measure(ledger, "short_span.apply", lambda: G.ss_apply(*fix, ss),
            lambda: G.ss_apply_plain(*fix, ss), n_bytes=n_bytes,
            n_ops=n_ops)
    # applications in a row over the same ranges, fewer writers committed
    # each time, as the fixpoint runs them: each exact after the timing's
    # hundreds of launches on the same cover
    leaves, wlo, whi, val, lq_lo, lq_hi = fix
    for k in range(3):
        exact(f"short_span.apply, application {k} in a row",
              G.ss_apply(leaves, wlo, whi, val, lq_lo, lq_hi, ss),
              G.ss_apply_plain(leaves, wlo, whi, val, lq_lo, lq_hi, ss))
        val = torch.where(torch.rand((B,), generator=gen, device=device)
                          < 0.3, G.INT32_POS, val)
    log(f"  kernel K input: {B} reads over a {sk.shape[0]}-row tier "
        f"({covered} segment reads); {B} writes and reads over {leaves} "
        f"local leaves ({n_leaves} leaves covered), S = {ss}")

    # -- the tiered stream at S
    cfg = bench_config(B, short_span_limit=ss)
    cs = make_conflict_set(cfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    per_batch, outs = [], []
    for i, b in enumerate(uni):
        t1 = time.perf_counter()
        out = cs.resolve_packed(b)
        torch.cuda.synchronize()
        per_batch.append(time.perf_counter() - t1)
        outs.append(verdict_fields(out))
    launches, launch_bytes = launch_totals()
    try:
        cs.check_overflow()
    except HistoryOverflowError:
        fail(f"the uniform stream tripped the span latch at S = {ss}")
    require_launched("short-span uniform", launches,
                     ("keysearch.query", "min_cover", "read_dedup",
                      *CLASSIC_ONLY, *SHARDED_ONLY, *CROSS_SPAN_ONLY,
                      *OFF_PATH))
    # phase (b) against the delta tier: one kernel E launch a batch
    if launches["sweep_ranks"] != len(uni):
        fail(f"short-span uniform: {launches['sweep_ranks']} kernel E "
             f"launches over {len(uni)} batches, not one a batch")
    for name in ("min_cover", "rangemax2.build", "rangemax2.query"):
        if launches[name]:
            fail(f"{name}: launched on the short-span uniform path")
    for i, (got, want) in enumerate(zip(outs, tiered_ref["outs"])):
        same_fields(f"short-span batch {i} vs S = 0 on the card", got, want)
    same_state("short-span uniform stream vs S = 0 on the card",
               state_of(cs), tiered_ref["final"])
    cpu = make_conflict_set(cfg, "cuda", device="cpu")
    t1 = time.perf_counter()
    same_fields("short-span batch 0 vs the CPU plain path", outs[0],
                verdict_fields(cpu.resolve_packed(uni[0])))
    log(f"  {len(uni)} batches at S = {ss}: every field and both tiers "
        f"identical to S = 0 on the card, batch 0 to the CPU plain path "
        f"({time.perf_counter() - t1:.1f} s on the CPU); launches "
        f"{launches}")
    n_cmp = COMPACT_INTERVAL + 1
    ms = statistics.median(per_batch[n_cmp:]) * 1e3
    log(f"  steady state: {ms:.3f} ms/batch median over batches "
        f"{n_cmp}..{len(uni) - 1} (S = 0: {tiered_ref['ms']:.3f}), "
        f"{B / (ms / 1e3):,.0f} txn/s")
    extra = uniform_stream(cfg, 2, seed=1, start=len(uni))

    def run():
        for b in extra:
            cs.resolve_packed(b)

    prof = profile_run(run, ms, len(extra))

    # -- classic groups of 8 at S
    ccfg = bench_config(B, delta_capacity=0, short_span_limit=ss)
    groups = groups_of(uni)
    cl = make_conflict_set(ccfg, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    c_times, c_outs = [], []
    for gi, g in enumerate(groups):
        t1 = time.perf_counter()
        out = cl.resolve_group_args(g)
        torch.cuda.synchronize()
        c_times.append(time.perf_counter() - t1)
        c_outs.append(verdict_fields(out))
        same_fields(f"short-span classic group {gi} vs S = 0 on the card",
                    c_outs[-1], classic_ref["outs"][gi])
        same_state(f"short-span classic group {gi} vs S = 0 on the card",
                   state_of(cl), classic_ref["maps"][gi])
        if gi == 0:
            first = state_of(cl)
    c_launches, c_bytes = launch_totals()
    require_launched("short-span classic", c_launches,
                     ("keysearch.query", "keysearch.probe", "rangemax_build",
                      "min_cover", "read_dedup", "rangemax2.build",
                      "rangemax2.query", *SHARDED_ONLY, *OFF_PATH))
    # a group's phase (b) is one kernel E launch, its cross span one
    # both-sides and one left search (ops/group._block_spans)
    if (c_launches["sweep_ranks"], c_launches["keysearch.search"]) != (
            len(groups), 2 * len(groups)):
        fail(f"short-span classic: {c_launches['sweep_ranks']} kernel E and "
             f"{c_launches['keysearch.search']} search launches over "
             f"{len(groups)} groups, not 1 and 2 a group")
    for name in ("min_cover", "rangemax2.build", "rangemax2.query"):
        if c_launches[name]:
            fail(f"{name}: launched on the short-span classic path")
    one_fold_a_batch("short-span classic", c_launches, len(uni))
    cpu = make_conflict_set(ccfg, "cuda", device="cpu")
    t1 = time.perf_counter()
    same_fields("short-span classic group 0 vs the CPU plain path",
                c_outs[0], verdict_fields(cpu.resolve_group_args(groups[0])))
    same_state("short-span classic group 0 vs the CPU plain path", first,
               state_of(cpu))
    c_ms = group_timing(f"classic G={GROUP} at S = {ss}", c_times)
    log(f"  {len(groups)} classic groups at S = {ss}: every field and the "
        f"tier identical to S = 0 on the card after every group, group 0 "
        f"to the CPU plain path ({time.perf_counter() - t1:.1f} s on the "
        f"CPU); launches {c_launches}")
    c_extra = groups_of(uniform_stream(ccfg, GROUP, seed=1,
                                       start=len(uni)))[0]
    c_prof = profile_run(lambda: cl.resolve_group_args(c_extra), c_ms,
                         GROUP)

    # -- one group on 4 shards at S
    scfg = bench_config(B, n_shards=SHARDS, short_span_limit=ss)
    sh = make_conflict_set(scfg, "cuda", shard_boundaries=quartiles())
    reset_launches()
    t1 = time.perf_counter()
    s_out = verdict_fields(sh.resolve_group_args(groups[0]))
    torch.cuda.synchronize()
    s_ms = (time.perf_counter() - t1) / GROUP * 1e3
    s_launches, _ = launch_totals()
    for name in ("short_span.range", "short_span.apply", "shard_clip",
                 "shard_combine"):
        if s_launches[name] <= 0:
            fail(f"{name}: not launched on the short-span sharded path")
    same_fields(f"short-span group 0 on {SHARDS} shards vs S = 0",
                s_out, sharded_ref["outs0"])
    same_state(f"short-span group 0 on {SHARDS} shards vs S = 0",
               state_of(sh), sharded_ref["state0"])
    log(f"  group 0 on {SHARDS} shards at S = {ss}: every field and every "
        f"shard's tiers identical to S = 0 on the card ({s_ms:.3f} "
        "ms/batch, first group, unwarmed)")

    # -- a forced trip: YCSB-E scans span far more than S (a group of 2,
    #    which fits the delta tier: at S = 0 it does not overflow)
    trip_group = groups_of(ycsb[:2])[0]
    for limit in (0, ss):
        tr = make_conflict_set(bench_config(B, short_span_limit=limit),
                               "cuda")
        tr.resolve_group_args(trip_group)
        try:
            tr.check_overflow()
        except HistoryOverflowError as e:
            if not limit:
                fail("the YCSB-E trip group overflows at S = 0")
            log(f"  forced trip: a YCSB-E group of 2 at S = {ss} raised "
                f"HistoryOverflowError ({str(e)[:48]}...); at S = 0 it "
                "did not")
        else:
            if limit:
                fail(f"a YCSB-E group at S = {ss} did not trip the span "
                     "latch")
    return dict(ledger=ledger, short_span_limit=ss, widest_spans=widest,
                uniform=dict(launches=launches, launch_bytes=launch_bytes,
                             batches=len(uni), ms_per_batch=ms,
                             txn_per_s=B / ms * 1e3, **prof),
                classic=dict(launches=c_launches, launch_bytes=c_bytes,
                             batches=len(uni), ms_per_batch=c_ms,
                             txn_per_s=B / c_ms * 1e3, **c_prof),
                sharded_group0_ms_per_batch=s_ms)


def np_lex_less(a, b):
    """a < b for packed uint32 key rows [..., W] (numpy, broadcast): the
    first differing word decides."""
    a, b = np.broadcast_arrays(a, b)
    diff = a != b
    k = diff.argmax(axis=-1)[..., None]
    return diff.any(axis=-1) & (np.take_along_axis(a, k, -1)[..., 0]
                                < np.take_along_axis(b, k, -1)[..., 0])


def np_partition():
    """[SHARDS, W] uint32 (lo, hi) of the quartile split: b"" below shard
    0, the +inf sentinel above the last."""
    lo = np.zeros((SHARDS, W), np.uint32)
    hi = np.full((SHARDS, W), 0xFFFFFFFF, np.uint32)
    for i, key in enumerate(quartiles()):
        v = int.from_bytes(key, "big")
        hi[i] = lo[i + 1] = (v >> 32, v & 0xFFFFFFFF, KEY_BYTES)
    return lo, hi


def np_clip(g: dict, lo, hi) -> dict:
    """This script's own clip of a stacked numpy group to one shard's
    [lo, hi): what a commit proxy sends that resolver."""
    out = dict(g)
    for side in ("read", "write"):
        b, e = g[f"{side}_begin"], g[f"{side}_end"]
        cb = np.where(np_lex_less(b, lo)[..., None], lo, b)
        ce = np.where(np_lex_less(e, hi)[..., None], e, hi)
        out[f"{side}_begin"], out[f"{side}_end"] = cb, ce
        out[f"{side}_valid"] = g[f"{side}_valid"] & np_lex_less(cb, ce)
    gn, b = g["txn_valid"].shape
    hits = np.zeros((gn, b + 1), bool)
    rows, cols = np.nonzero(out["read_valid"])
    hits[rows, g["read_txn"][rows, cols]] = True
    out["has_reads"] = hits[:, :b]
    return out


def np_combine(per: list, txn_valid) -> dict:
    """The resolvers' GroupVerdict fields combined as a commit proxy does:
    min() verdicts, the first index the least non-negative one, hits and
    flags OR'd, the counts taken from the combined verdict."""
    import torch

    def stack(f):
        return np.stack([p[f].numpy() for p in per])

    v = stack("verdict").min(axis=0)
    first = stack("intra_first_range")
    f = np.where(first < 0, 2**31 - 1, first).min(axis=0)
    out = dict(verdict=v,
               hist_conflict_read=stack("hist_conflict_read").any(axis=0),
               intra_first_range=np.where(f == 2**31 - 1, -1, f),
               committed_count=((v == 3) & txn_valid).sum(axis=1),
               conflict_count=((v == 0) & txn_valid).sum(axis=1),
               too_old_count=((v == 1) & txn_valid).sum(axis=1),
               overflow=stack("overflow").any(axis=0),
               unconverged=stack("unconverged").any(axis=0))
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(per[0][k].dtype)
            for k, x in out.items()}


def shard_state(state, s: int):
    """Shard s's (main, delta) leaves of a stacked sharded state."""
    return tuple(tuple(x[s] for x in tier) for tier in state)


def straddling_reads(batches) -> tuple:
    """(live reads, reads whose range crosses a quartile boundary)."""
    lo, _ = np_partition()
    n = cross = 0
    for pb in batches:
        rb, re = pb.read_begin[: pb.n_reads], pb.read_end[: pb.n_reads]
        n += pb.n_reads
        cross += int(sum((np_lex_less(rb, k) & np_lex_less(k, re)).sum()
                         for k in lo[1:]))
    return n, cross


def phase_sharded(device, uni, ycsb) -> dict:
    """Four resolvers on one card over the keyspace quartiles: the
    uniform groups (exact) against four independent single-shard sets
    fed this script's numpy clip; YCSB-E with sweep + spill + latch
    against the probe path; a forced-trip group."""
    import torch

    from foundationdb_tpu_torch import make_conflict_set
    from foundationdb_tpu_torch.ops import delta as D

    cfg = bench_config(B, n_shards=SHARDS)
    bounds = quartiles()
    batches = uni[:SHARD_GROUPS * GROUP]
    groups = groups_of(batches)
    cs = make_conflict_set(cfg, "cuda", shard_boundaries=bounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    times, outs, states = [], [], []
    for g in groups:
        t0 = time.perf_counter()
        out = cs.resolve_group_args(g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(verdict_fields(out))
        states.append(state_of(cs))
    launches, launch_bytes = launch_totals()
    peak = torch.cuda.max_memory_allocated(device)
    cs.check_overflow()
    require_launched("sharded uniform", launches,
                     ("sweep_ranks", "read_dedup", *CLASSIC_ONLY,
                      *SHORT_SPAN_ONLY, *CROSS_SPAN_ONLY, *OFF_PATH))
    splits = [int.from_bytes(k, "big") for k in bounds]
    log(f"  {len(batches)} batches x {B} txns in groups of {GROUP} on "
        f"{SHARDS} shards split at {splits} (tiers of "
        f"{cfg.history_capacity} rows each); launches: {launches}")
    ms = group_timing(f"{SHARDS} shards, exact", times)

    # four independent resolvers, each fed this script's clip of every
    # batch, combined here
    lo, hi = np_partition()
    singles = [make_conflict_set(bench_config(B), "cuda")
               for _ in range(SHARDS)]
    shard_reads, phantoms = [], 0
    for gi, g in enumerate(groups):
        per = []
        for s, one in enumerate(singles):
            local = np_clip(g, lo[s], hi[s])
            if gi == 0:
                shard_reads.append(int(local["read_valid"].sum()))
            per.append(verdict_fields(one.resolve_group_args(local)))
            same_state(f"sharded group {gi}: shard {s} vs its own resolver",
                       shard_state(states[gi], s), state_of(one))
        want = np_combine(per, g["txn_valid"])
        same_fields(f"sharded group {gi} vs {SHARDS} resolvers combined "
                    "here", outs[gi], want)
        combined = want["verdict"].numpy()
        phantoms += int(sum(((p["verdict"].numpy() == 3) & (combined != 3)
                             & g["txn_valid"]).sum() for p in per))
    log(f"  every group identical to {SHARDS} independent resolvers fed "
        f"this script's numpy clip and combined with numpy, each shard's "
        f"tiers identical to its resolver's after every group; live reads "
        f"per shard in group 0 {shard_reads}; {phantoms} phantom commits "
        "(a txn merged on a shard that another shard aborted)")
    occupancy = [[int(c) for c in x]
                 for x in D.boundary_counts_per_shard(cs.state)]
    log(f"  live rows per shard after the stream (main, delta): "
        f"{occupancy}; peak device memory {peak / 2**20:.1f} MiB")

    # YCSB-E scans across the quartiles: sweep + spill + latch vs probe
    ycfg = cfg.scaled(fixpoint_unroll=YCSB_UNROLL, fixpoint_latch=True,
                      range_sweep=True, delta_spill=True)
    ybatches = ycsb[:SHARD_YCSB_GROUPS * GROUP]
    n_reads, cross = straddling_reads(ybatches)
    ygroups = groups_of(ybatches)
    sw = make_conflict_set(ycfg, "cuda", shard_boundaries=bounds)
    sw.prewarm_exact(ygroups[0])
    torch.cuda.synchronize()
    reset_launches()
    y_times, y_outs, y_first = run_groups(sw, ygroups)
    y_launches, _ = launch_totals()
    for name in ("sweep_ranks", "shard_clip", "shard_combine"):
        if y_launches[name] <= 0:
            fail(f"{name}: not launched on the sharded range-scan path")
    pr = make_conflict_set(ycfg.scaled(range_sweep=False), "cuda",
                           shard_boundaries=bounds)
    p_times, p_outs, p_first = run_groups(pr, ygroups)
    for i, (g, w) in enumerate(zip(y_outs, p_outs)):
        same_fields(f"sharded range-scan group {i} vs the probe path", g, w)
    same_state("sharded range-scan group 0 vs the probe path", y_first,
               p_first)
    same_state("sharded range-scan stream vs the probe path", state_of(sw),
               state_of(pr))
    yc = sw.metrics.counters.as_dict()
    y_ms = statistics.mean(t / GROUP * 1e3 for t in y_times)
    p_ms = statistics.mean(t / GROUP * 1e3 for t in p_times)
    log(f"  YCSB-E on {SHARDS} shards ({cross} of {n_reads} reads straddle "
        f"a boundary): {len(ybatches)} batches identical to the probe path, "
        f"fields and every shard's tiers; sweep {y_ms:.3f}, probe {p_ms:.3f} "
        f"ms/batch (mean of {len(ygroups)} groups); counters {yc}")

    # the latch at unroll 1 trips on some shard: every shard falls back
    tr = make_conflict_set(cfg.scaled(fixpoint_latch=True, fixpoint_unroll=1),
                           "cuda", shard_boundaries=bounds)
    tr.prewarm_exact(groups[0])
    _, tr_outs, tr_first = run_groups(tr, groups[:1])
    tc = tr.metrics.counters.as_dict()
    if not tc["latchTrips"] == tc["exactFallbacks"] == 1:
        fail(f"sharded forced trip: expected one fallback, counters {tc}")
    same_fields("sharded forced-trip group 0 vs the exact run", tr_outs[0],
                outs[0])
    same_state("sharded forced-trip group 0 vs the exact run", tr_first,
               states[0])
    log(f"  unroll 1 (forced trip): latchTrips {tc['latchTrips']} == "
        f"exactFallbacks {tc['exactFallbacks']}, every shard's tiers and "
        "every field identical to the exact run")

    extra = groups_of(uniform_stream(cfg, GROUP, seed=1, start=len(uni)))
    prof = profile_run(lambda: cs.resolve_group_args(extra[0]), ms, GROUP)
    c = cs.metrics.counters.as_dict()
    col = cs.metrics.collective
    log(f"  compactions {c['compactions']}; collective (kernel J alone, "
        f"fenced) {col.total / max(col.count, 1) * 1e6:.1f} us over "
        f"{col.count} samples")
    return dict(launches=launches, launch_bytes=launch_bytes,
                batches=len(batches), shards=SHARDS, ms_per_batch=ms,
                outs0=outs[0], state0=states[0],
                txn_per_s=B / ms * 1e3, peak_device_mib=peak / 2**20,
                phantom_commits=phantoms,
                range_scan={"batches": len(ybatches), "ms_per_batch": y_ms,
                            "probe_ms_per_batch": p_ms,
                            "straddling_reads": cross, "reads": n_reads,
                            "spills": yc["spills"],
                            "latch_trips": yc["latchTrips"]},
                trip_run={"fixpoint_unroll": 1,
                          "latch_trips": tc["latchTrips"],
                          "exact_fallbacks": tc["exactFallbacks"]},
                **prof)


def phase_oracle(device) -> None:
    """2,048-txn contended stream through resolve() on four configs
    (exact; latched + dedup; sweep + spill + latch; classic): verdicts
    and conflict reports identical to the copied ConflictOracle; the
    classic config in groups of 4 (resolve_group_args), verdicts
    identical; and the exact config at 2 and 4 shards, verdicts identical
    to the copied MultiResolverOracle."""
    from foundationdb_tpu_torch import make_conflict_set
    from foundationdb_tpu_torch.models.types import CommitTransaction
    from foundationdb_tpu_torch.testing.benchgen import skiplist_style_batch
    from foundationdb_tpu_torch.testing.oracle import (
        MultiResolverOracle,
        OracleTxn,
    )
    from foundationdb_tpu_torch.utils.packing import (
        pack_batch,
        stack_device_args,
        unpack_key,
    )

    n = 2048
    base = bench_config(n).scaled(compact_interval=3)
    rng = np.random.default_rng(7)
    oracle = make_conflict_set(base, "cpu")
    stream = []
    for i in range(8):
        # versions start past the snapshot lag: commit versions and read
        # snapshots are non-negative, as the oracle's background 0 assumes
        pb = skiplist_style_batch(rng, base, n,
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
        stream.append((txns, int(pb.version),
                       oracle.resolve(txns, int(pb.version))))
    n_conflict = sum(int(v) == 0 for _, _, w in stream for v in w.verdicts)
    if n_conflict == 0:
        fail("oracle stream produced no conflicts; it checks nothing")
    configs = {
        "exact": base,
        "latched + dedup": base.scaled(fixpoint_latch=True,
                                       fixpoint_unroll=4, dedup_reads=n),
        "sweep + spill + latch": base.scaled(
            range_sweep=True, delta_spill=True, fixpoint_latch=True,
            fixpoint_unroll=4, delta_capacity=6 * n, compact_interval=0),
        "classic": base.scaled(delta_capacity=0),
    }
    for name, cfg in configs.items():
        cs = make_conflict_set(cfg, "cuda")
        for i, (txns, version, want) in enumerate(stream):
            got = cs.resolve(txns, version)
            if got.verdicts != want.verdicts:
                fail(f"oracle batch {i} ({name}): verdicts differ")
            if got.conflicting_key_ranges != want.conflicting_key_ranges:
                fail(f"oracle batch {i} ({name}): conflicting key ranges "
                     "differ")
        c = cs.metrics.counters.as_dict()
        log(f"  {name}: 8 batches x {n} txns identical to ConflictOracle "
            f"({n_conflict} conflicts; latchTrips {c['latchTrips']}, "
            f"spills {c['spills']}, sweepGroups {c['sweepGroups']})")
    # the classic group kernel: groups of 4 through resolve_group_args
    cs = make_conflict_set(configs["classic"], "cuda")
    for lo in range(0, len(stream), 4):
        part = stream[lo:lo + 4]
        out = cs.resolve_group_args(stack_device_args([
            pack_batch(txns, version, cs.base_version, cs.config)
            for txns, version, _ in part]))
        verdict = out.verdict.cpu().numpy()
        for j, (txns, _, want) in enumerate(part):
            if [int(v) for v in verdict[j, :len(txns)]] != [
                    int(v) for v in want.verdicts]:
                fail(f"oracle batch {lo + j} (classic, G=4): verdicts "
                     "differ")
    log(f"  classic, groups of 4: 8 batches x {n} txns identical to "
        f"ConflictOracle, verdict for verdict")
    # sharded at 2 and 4 shards, split evenly over the stream's keyspace,
    # against the multi-resolver oracle (verdicts: its conflict report is
    # the union of the shards' reports, the set's the report of the
    # combined hits)
    for n_shards in (2, 4):
        bounds = [(i * 20_000 // n_shards).to_bytes(KEY_BYTES, "big")
                  for i in range(1, n_shards)]
        multi = MultiResolverOracle(bounds, window=base.window_versions)
        cs = make_conflict_set(base.scaled(n_shards=n_shards), "cuda",
                               shard_boundaries=bounds)
        differ = 0
        for i, (txns, version, single) in enumerate(stream):
            want = multi.resolve([OracleTxn(
                t.read_conflict_ranges, t.write_conflict_ranges,
                t.read_snapshot, t.report_conflicting_keys) for t in txns],
                version).verdicts
            got = [int(v) for v in cs.resolve(txns, version).verdicts]
            if got != want:
                fail(f"oracle batch {i} ({n_shards} shards): verdicts differ "
                     "from MultiResolverOracle")
            differ += sum(a != int(b) for a, b in zip(want, single.verdicts))
        log(f"  sharded, {n_shards} shards: 8 batches x {n} txns identical "
            f"to MultiResolverOracle ({differ} verdicts differ from the "
            "single resolver's)")


def build_summary(built: dict) -> None:
    """Per source: the most registers any instantiation uses, and any
    spill (-Xptxas -v)."""
    import re as _re

    for name, text in sorted(built.items()):
        regs = [int(x) for x in _re.findall(r"Used (\d+) registers", text)]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not _re.search(
                      r"0 bytes spill stores, 0 bytes spill loads", line)]
        errors = [line.strip() for line in text.splitlines()
                  if "error" in line]
        log(f"  [{name}] {len(regs)} kernels, max {max(regs or [0])} "
            f"registers; spills: {spills or 'none'}")
        for line in errors:
            log(f"  [{name}] {line}")


def time_build_cover(device) -> dict:
    """Kernels B and C alone, at the shapes the resolver path gives them
    (B over a 786,432-row tier, max, and over the fixpoint's 2^18 leaves,
    min; C over 2^18 leaves and 65,536 write intervals as in phase 2),
    each held to its plain version and timed as phase 2 times it. Run
    from another checkout's root (a copy of this script there) it times
    that tree's kernels: the way two trees are compared in one call."""
    import torch

    from foundationdb_tpu_torch.ops import rangemax, segtree

    gen = torch.Generator(device=device)
    gen.manual_seed(20261018)
    leaves = 4 * B
    ledger = {}
    for m, op in ((M, "max"), (leaves, "min")):
        vals = torch.randint(-5_000_000, 5_000_000, (m,), generator=gen,
                             device=device, dtype=torch.int32)
        levels = rangemax._num_levels(m)
        measure(ledger, "rangemax_build",
                lambda: rangemax.build(vals, op=op),
                lambda: rangemax.build_plain(vals, op=op),
                n_bytes=(1 + levels) * m * 4, n_ops=(levels - 1) * m,
                key=f"B {op} {m}")
    lo, hi, val = cover_intervals(gen, leaves, B, device)
    measure(ledger, "min_cover",
            lambda: segtree.min_cover(leaves, lo, hi, val),
            lambda: segtree.min_cover_plain(leaves, lo, hi, val),
            n_bytes=3 * B * 4 + leaves * 4,
            n_ops=2 * B + 2 * (leaves.bit_length() - 1) * leaves,
            key=f"C {leaves}")
    return ledger


def time_merge(device) -> dict:
    """Kernel D alone at the resolver path's two shapes, as phase 2 times
    it (`merge_rows`: the compaction's M + M rows, the batch merge's M +
    2B), on inputs made as phase 2 makes them from a seed of its own. Run
    from another checkout's root (a copy of this script there) it times
    that tree's kernel D."""
    import torch

    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H

    gen = torch.Generator(device=device)
    gen.manual_seed(20261019)
    tiers = []
    for n_live, lo, hi in ((3 * M // 4, 0, 3_000_000),
                           (M // 3, 2_000_000, 4_000_000)):
        keys, n = random_sorted_keys(gen, n_live, M, device)
        val = torch.randint(lo, hi, (M,), generator=gen, device=device,
                            dtype=torch.int32)
        val[n:] = H.VERSION_NEG
        tiers.append((keys, val))
    begin = torch.randint(0, 1 << 40, (B,), generator=gen, device=device)
    rb = int_keys(begin)
    re = int_keys(begin + torch.randint(1, 1 << 30, (B,), generator=gen,
                                        device=device))
    cw = torch.rand((B,), generator=gen, device=device) < 0.97
    ledger = {}
    merge_rows(ledger, *tiers, G._coverage(rb, re, cw, 4_000_000))
    return ledger


def time_writes_radix4(device) -> dict:
    """K16 and kernel M's three entries alone at phase 2's shapes
    (`writes_radix4_rows`), on inputs made as phase 2 makes them from a
    seed of its own; then, in the same process, the kernels the new
    entries share code with: B and C as `time_build_cover` times them, B
    at the fixpoint's depth and C over phase 2's writer cover, and D at
    its two shapes (`time_merge`). Run from another checkout's root (a
    copy of this script there) it times that tree's kernels."""
    import torch

    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import rangemax, segtree

    gen = torch.Generator(device=device)
    gen.manual_seed(20261021)
    ledger = {}
    writes_radix4_rows(ledger, gen, device)
    ledger.update(time_build_cover(device))
    # B at the fixpoint's depth and C at phase 2's writer cover: the rows
    # the resolver path reads
    leaves, depth = 4 * B, G.FIXPOINT_LEVELS
    vals = torch.randint(0, B, (leaves,), generator=gen, device=device,
                         dtype=torch.int32)
    measure(ledger, "rangemax_build",
            lambda: rangemax.build(vals, op="min", levels=depth),
            lambda: rangemax.build_plain(vals, op="min", levels=depth),
            n_bytes=(1 + depth) * leaves * 4, n_ops=(depth - 1) * leaves,
            key=f"B min {leaves} L{depth}")
    wlo, whi, wval = writer_cover(gen, leaves, device)
    measure(ledger, "min_cover",
            lambda: segtree.min_cover(leaves, wlo, whi, wval),
            lambda: segtree.min_cover_plain(leaves, wlo, whi, wval),
            **cover_bound(leaves), key=f"C {leaves} writer cover")
    ledger.update(time_merge(device))
    return ledger


def time_probe_fold(device) -> dict:
    """Kernels A's probe and H alone at the resolver path's shapes, as
    phase 2 times them (`probe_rows`: long reads and the uniform stream's
    point reads against a 786,432-row tier; `fold_row`: a classic group
    of 8's 2,097,152 ranks), on inputs made as phase 2 makes them from a
    seed of its own. Run from another checkout's root (a copy of this
    script there) it times that tree's kernels."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(20261020)
    uni = uniform_stream(bench_config(B), GROUP)
    ledger = {}
    probe_rows(ledger, probe_long_reads(gen, device),
               uniform_point_reads(gen, uni[0], device))
    ranks, n_map = group_ranks(uni, device)
    fold_row(ledger, gen, ranks, n_map)
    return ledger


def probe_long_reads(gen, device) -> tuple:
    """Kernel A's probe at long reads: 65,536 reads over a 786,432-row
    tier 3/4 live of random 8-byte keys, most spanning many segments, a
    quarter of each end on a tier key, with random versions: (hist,
    table, rb, re)."""
    import torch

    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K
    from foundationdb_tpu_torch.ops import rangemax

    main_keys, n_main = random_sorted_keys(gen, 3 * M // 4, M, device)
    ver = torch.randint(-5_000_000, 5_000_000, (M,), generator=gen,
                        device=device, dtype=torch.int32)
    begin = torch.randint(0, 1 << 40, (B,), generator=gen, device=device)
    rb = int_keys(begin)
    rb[: B // 4] = main_keys[torch.randint(0, n_main, (B // 4,),
                                           generator=gen, device=device)]
    re = int_keys(begin + torch.randint(1, 1 << 30, (B,), generator=gen,
                                        device=device))
    re[: B // 4] = main_keys[torch.randint(0, n_main, (B // 4,),
                                           generator=gen, device=device)]
    inv = K.lex_less(re, rb)[:, None]
    rb, re = (torch.where(inv, re, rb).contiguous(),
              torch.where(inv, rb, re).contiguous())
    hist = H.VersionHistory(main_keys, ver, H.VERSION_NEG,
                            torch.zeros((), dtype=torch.bool, device=device))
    return hist, rangemax.build_plain(ver, op="max"), rb, re


def time_short_span(device) -> dict:
    """One short-span fixpoint application alone at the uniform batch's
    shapes (S = 4: 65,536 writes and reads in local ranks over 2^18
    leaves, `fixpoint_inputs` from a seed of its own), as this tree runs
    it: kernel K's `ss_apply`, one launch, where the tree has it; in a
    tree before it, the fill of a new cover, `ss_cover` and the
    `ss_range` min, in that order. Held to the plain version; the device
    time (checked profiler sessions, median of three), the time a call
    with its launch gaps (CUDA events), the plain version's, the bound,
    the launches of one call and its device µs by kernel. Run from
    another checkout's root (a copy of this script there) it times that
    tree's: parent, change, change, parent in one call."""
    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import group as G

    gen = torch.Generator(device=device)
    gen.manual_seed(20261021)
    ss = 4
    fix = fixpoint_inputs(gen, uniform_stream(bench_config(B), 1)[0],
                          device)
    leaves, wlo, whi, val, lq_lo, lq_hi = fix
    if hasattr(G, "ss_apply"):
        name = "ss_apply"

        def app():
            return G.ss_apply(*fix, ss)
    else:
        name = "fill + ss_cover + ss_range"

        def app():
            return G.ss_range(G.ss_cover(leaves, wlo, whi, val, ss), lq_lo,
                              lq_hi, ss, op="min")

    def plain():
        return G.ss_range_plain(G.ss_cover_plain(leaves, wlo, whi, val, ss),
                                lq_lo, lq_hi, ss, op="min")

    before = kernels.counts()
    got = app()
    launched = {k: n - before[k] for k, n in kernels.counts().items()
                if n != before[k]}
    err = exact(name, got, plain())
    n_bytes, n_ops, n_leaves = apply_bound(*fix, ss)
    b, by = bound_ms(n_bytes, n_ops)
    by_kernel = {k[:70]: round(t, 2) for k, t in profiled(app).items()}
    row = dict(max_abs_err=err, ms=device_ms(app, sessions=3),
               call_ms=event_ms(app), plain_ms=device_ms(plain, reps=3),
               bound_ms=b, bound_by=by, covered_leaves=n_leaves,
               launches_per_call=launched, device_us_by_kernel=by_kernel)
    log(f"  {name}: device {row['ms'] * 1e3:.2f} us, a call with its "
        f"launch gaps {row['call_ms'] * 1e3:.2f} us, bound "
        f"{b * 1e3:.2f} us ({by}), plain {row['plain_ms'] * 1e3:.1f} us, "
        f"launches {launched}, by kernel {by_kernel}")
    return {name: row}


def kernel_us(fn, reps: int = 10, sessions: int = 3) -> dict:
    """Median device µs a call of fn() by kernel: the port's by their
    function name (both instantiations of a template summed), other work
    by its record's name; from checked profiler sessions."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    per = []
    for _ in range(sessions):
        row = {}
        for k, t in profiled(many).items():
            m = PORT_KERNEL.match(k)
            name = m.group(1) if m else k[:60]
            row[name] = row.get(name, 0.0) + t / reps
        per.append(row)
    return {k: round(statistics.median(p.get(k, 0.0) for p in per), 3)
            for k in sorted(set().union(*per))}


def long_path_rows(mw, lo, hi) -> dict:
    """What the long path costs kernel A's query over the fixpoint's
    FIXPOINT_LEVELS-level min table, beside the full table: the uniform
    fixpoint's reads (lo, hi) as they are, then with read 0 spanning
    2^10 .. 2^18 leaves from 0, with the first 32 reads (one warp's) over
    the whole leaf range, and with every 32nd read (one a warp) over it.
    Each held to the plain version; device µs of the query alone (the
    tables built once)."""
    import torch

    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import rangemax

    m = mw.shape[0]
    tables = {"cut": rangemax.build(mw, op="min", levels=G.FIXPOINT_LEVELS),
              "full": rangemax.build(mw, op="min")}
    cases = {"as is": lo.new_zeros(0)}
    for bits in range(10, m.bit_length(), 2):
        cases[f"read 0 over 2^{bits}"] = torch.tensor([0], device=lo.device)
    cases["one warp's 32 reads over all"] = torch.arange(32, device=lo.device)
    cases["a read a warp over all"] = torch.arange(0, lo.shape[0], 32,
                                                   device=lo.device)
    out = {}
    for name, idx in cases.items():
        qlo, qhi = lo.clone(), hi.clone()
        qlo[idx] = 0
        span = (1 << int(name.split("2^")[1])) if "2^" in name else m
        qhi[idx] = span
        want = rangemax.query_plain(tables["full"], qlo, qhi, op="min")
        row = {}
        for tag, tab in tables.items():
            exact(f"A query long path, {name}, {tag}",
                  rangemax.query(tab, qlo, qhi, op="min"), want)
            us = kernel_us(lambda: rangemax.query(tab, qlo, qhi, op="min"))
            row[f"{tag}_us"] = round(sum(us.values()), 3)
        out[name] = row
        log(f"  A query long path, {name}: {row}")
    return out


def time_queries(device) -> dict:
    """Kernels A's query and G alone. The exact fixpoint's min table and
    query (kernel B at op min, then A's query) at a uniform and a
    range-scan batch's fixpoint (`fixpoint_inputs`: 65,536 writes and
    reads in local ranks over 2^18 leaves; the table over their min
    cover): at every level, and at each depth of LEVEL_CHOICES where this
    tree's `rangemax.build` takes one, then what the long path costs
    (`long_path_rows`); and kernel G's build and query at
    a classic group of 8's 2,097,152 ranks (`g_rows`: the stream's ranks
    and the synthetic mix). Each held to its plain version; device µs by
    kernel (checked profiler sessions, median of three), the launches of
    one call. The span survey of the batches used is logged. Run from
    another checkout's root (a copy of this script there) it times that
    tree's: parent, change, change, parent in one call."""
    import inspect

    import torch

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.ops import rangemax

    gen = torch.Generator(device=device)
    gen.manual_seed(20261022)
    cfg = bench_config(B)
    uni = uniform_stream(cfg, GROUP)
    fixes = {"uniform": uni[0], "range_scan": ycsb_stream(cfg, 1)[0]}
    out = {"read_spans": survey_read_spans(
        device, {k: [v] for k, v in fixes.items()})}
    depths = ([None, *LEVEL_CHOICES] if "levels" in inspect.signature(
        rangemax.build).parameters else [None])
    for tag, batch in fixes.items():
        fix = fixpoint_inputs(gen, batch, device)
        mw, lo, hi = fixpoint_cover(fix), fix[4], fix[5]
        want = rangemax.query_plain(rangemax.build_plain(mw, op="min"), lo,
                                    hi, op="min")
        for levels in depths:
            kw = {} if levels is None else {"levels": levels}

            def app():
                return rangemax.query(rangemax.build(mw, op="min", **kw), lo,
                                      hi, op="min")

            before = kernels.counts()
            got = app()
            launched = {k: n - before[k] for k, n in kernels.counts().items()
                        if n != before[k]}
            depth = levels or rangemax._num_levels(mw.shape[0])
            exact(f"B + A query, {tag}, L = {depth}", got, want)
            by = kernel_us(app)
            row = dict(levels=depth, launches_per_call=launched,
                       device_us_by_kernel=by,
                       device_us=round(sum(by.values()), 3),
                       bound_us=bound_ms((1 + depth) * 4 * mw.shape[0]
                                         + query_bytes(depth, mw.shape[0],
                                                       lo, hi), 0)[0] * 1e3)
            out[f"{tag} fixpoint, L = {depth}"] = row
            log(f"  B + A query, {tag} fixpoint, L = {depth}: {row}")
        if tag == "uniform" and len(depths) > 1:
            out["long path"] = long_path_rows(mw, lo, hi)
    ranks, n_map = group_ranks(uni, device)
    ledger = {}
    g_rows(ledger, gen, ranks, n_map, device)
    out.update(ledger)
    return out


def time_searches(device) -> dict:
    """Kernels A's search and E alone, as this tree runs them, each held
    to its plain version, device µs by kernel (checked profiler sessions,
    median of three), the bound and the launches of one call: A's search
    left, right and both sides at the short-span classic path's shapes
    (search_inputs: 65,536 and 524,288 queries over a 786,432-row tier,
    and the group's 2,097,152 distinct point keys; "both" in a tree
    before the both-sides mode is its left and right searches); K6's
    counts at a uniform batch's read txn ids and a classic group of 8's
    flat segment ids; E at a YCSB-E group of 8's 524,288 reads
    (sweep_inputs); A's probe at long and point reads (probe_rows'
    inputs); and one short-span classic group of 8 (S = 4) over the
    tier its first group leaves, device µs by kernel. Run from another
    checkout's root (a copy of this script there) it times that tree's:
    parent, change, change, parent in one call."""
    import torch

    from foundationdb_tpu_torch import interop, kernels, make_conflict_set
    from foundationdb_tpu_torch.ops import delta as D
    from foundationdb_tpu_torch.ops import group as G
    from foundationdb_tpu_torch.ops import history as H
    from foundationdb_tpu_torch.ops import keys as K

    gen = torch.Generator(device=device)
    gen.manual_seed(20261023)
    cfg = bench_config(B)
    uni = uniform_stream(cfg, GROUP)
    out = {}

    def row(name, fn, want, n_bytes, n_ops=0):
        before = kernels.counts()
        got = fn()
        launched = {k: n - before[k] for k, n in kernels.counts().items()
                    if n != before[k]}
        exact_parts(name, got, want)
        by = kernel_us(fn)
        out[name] = dict(device_us=round(sum(by.values()), 3),
                         device_us_by_kernel=by,
                         bound_us=bound_ms(n_bytes, n_ops)[0] * 1e3,
                         launches_per_call=launched)
        log(f"  {name}: {out[name]}")

    def search(keys, q, side):
        if side == "both" and "both" not in getattr(K, "SIDES", ()):
            return (K.searchsorted(keys, q, side="left"),
                    K.searchsorted(keys, q, side="right"))
        return K.searchsorted(keys, q, side=side)

    keys, queries, ukeys = search_inputs(gen, uni, device)
    cases = [(side, n, q) for n, q in queries.items()
             for side in ("left", "right", "both")]
    cases.append(("both", "distinct point keys", ukeys))
    for side, n, q in cases:
        want = K.searchsorted_plain(keys, q, side=side) if side != "both" \
            else (K.searchsorted_plain(keys, q, side="left"),
                  K.searchsorted_plain(keys, q, side="right"))
        row(f"A search {side}, {n}", functools.partial(search, keys, q, side),
            want, *search_bound(keys, q, want if side == "both" else
                                (want,)))
    a = interop.device_args_to_torch(uni[0].device_args(), device)
    ids = {"uniform batch": (a["read_txn"], B + 1)}
    txn = torch.stack([interop.to_torch(b.device_args()["read_txn"], device)
                       for b in uni])
    seg = (torch.arange(GROUP, device=device)[:, None] * (B + 1) + txn)
    ids["classic group of 8"] = (seg.reshape(-1).to(torch.int32).contiguous(),
                                 GROUP * (B + 1))
    for tag, (x, n_seg) in ids.items():
        t = torch.arange(n_seg + 1, dtype=torch.int32, device=device)
        row(f"K6 counts, {tag}", functools.partial(G._sorted_counts, x, n_seg),
            K.searchsorted_plain(x.reshape(-1, 1), t.reshape(-1, 1),
                                 side="left"),
            4 * (x.shape[0] + n_seg + 1))
    main, rb, re, live = sweep_inputs(gen, ycsb_stream(cfg, GROUP), device)
    row("E, YCSB-E group of 8", functools.partial(D.sweep_read_ranks, main,
                                                  rb, re, live),
        D.sweep_read_ranks_plain(main, rb, re, live),
        sweep_bytes(main, rb, re, live))
    for tag, (hist, tab, prb, pre) in (
            ("long reads", probe_long_reads(gen, device)),
            ("point reads", uniform_point_reads(gen, uni[0], device))):
        q = prb.shape[0]
        row(f"A probe, {tag}", functools.partial(H.query_reads_vmax, hist,
                                                 prb, pre, tab),
            H.query_reads_vmax_plain(hist.main_keys, tab, prb, pre),
            4 * (deciding_rows(hist.main_keys, prb, pre) * W + 2 * q * W
                 + 3 * q))
    ss = 4
    ccfg = bench_config(B, delta_capacity=0, short_span_limit=ss)
    cl = make_conflict_set(ccfg, "cuda")
    cl.resolve_group_args(groups_of(uni)[0])
    g = interop.device_args_to_torch(groups_of(uniform_stream(
        ccfg, GROUP, seed=1, start=GROUP))[0], device)
    state = cl.state

    def group():
        return G.resolve_group(state, g, short_span_limit=ss)

    before = kernels.counts()
    group()
    launched = {k: n - before[k] for k, n in kernels.counts().items()
                if n != before[k]}
    by = kernel_us(group)
    out["short-span classic group of 8"] = dict(
        device_us=round(sum(by.values()), 3), device_us_by_kernel=by,
        launches_per_call=launched)
    log(f"  short-span classic group of 8 (S = {ss}): "
        f"{out['short-span classic group of 8']}")
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from foundationdb_tpu_torch import device as devmod
    from foundationdb_tpu_torch import kernels

    def heading(title: str) -> None:
        log(f"== {title} ({time.perf_counter() - T_START:.1f} s in)")

    device = devmod.resolve_device()
    heading("1. environment")
    fp = devmod.fingerprint(device)
    log("  " + json.dumps(fp))
    heading("build")
    t0 = time.perf_counter()
    count_launch_bytes()
    built = kernels.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    build_summary(built)
    alone = {"--build-cover": ("kernels B and C alone", "build_cover",
                               time_build_cover),
             "--merge": ("kernel D alone", "merge", time_merge),
             "--probe-fold": ("kernels A's probe and H alone", "probe_fold",
                              time_probe_fold),
             "--short-span": ("kernel K's fixpoint application alone",
                              "short_span", time_short_span),
             "--queries": ("kernels A's query and G alone", "queries",
                           time_queries),
             "--searches": ("kernels A's search and E alone", "searches",
                            time_searches),
             "--writes-radix4": ("K16 and kernel M alone, with B, C and D",
                                 "writes_radix4", time_writes_radix4)}
    if len(argv) == 1 and argv[0] in alone:
        title, key, timed = alone[argv[0]]
        heading(title)
        print(json.dumps({key: timed(device)}))
        print(devmod.nvidia_smi_name_power(device.index or 0), flush=True)
        return 0
    if argv:
        fail(f"unknown arguments {argv}; the options are "
             + " or ".join(alone))
    cfg = bench_config(B)
    zipf = zipf_stream(cfg, ZIPF_BATCHES)
    ycsb = ycsb_stream(cfg, YCSB_GROUPS * GROUP)
    uni = uniform_stream(cfg, N_BATCHES)
    dedup_u, max_uniq = dedup_size(zipf)
    heading("2. kernels vs plain versions (bench shapes)")
    read_spans = survey_read_spans(device, {"uniform": uni, "hot_key": zipf,
                                            "range_scan": ycsb})
    ledger = phase_kernels(device, zipf[0], ycsb[:GROUP], dedup_u,
                                     uni[:GROUP])
    torch_ops = phase_torch_ops(device)
    heading("3. uniform stream (bench default, exact)")
    uniform = phase_stream(device, uni)
    uniform_ref = {k: uniform[k] for k in ("outs", "ms_per_batch",
                                           "idle_share",
                                           "htod_ms_per_batch")}
    heading("4. hot-key stream (bench zipf: latch + read dedup)")
    hot = phase_hot_key(device, zipf, dedup_u, max_uniq)
    heading("5. range-scan stream (bench ycsb_e: sweep + spill + latch)")
    scan = phase_range_scan(device, ycsb)
    heading("6. classic uniform stream (bench BENCH_KERNEL=classic)")
    classic = phase_classic(device, uni, uniform["outs"])
    classic_ref = {k: classic[k] for k in ("outs", "ms_per_batch",
                                           "idle_share",
                                           "htod_ms_per_batch")}
    heading("7. classic hot-key stream (bench classic zipf: latch)")
    classic_hot = phase_classic_hot(device, zipf)
    heading("8. the wire Resolver role's shape vs ConflictOracle")
    role = phase_resolver_role(device)
    role_results = role.pop("results")
    heading(f"9. sharded uniform stream ({SHARDS} resolvers on the card)")
    sharded = phase_sharded(device, uni, ycsb)
    heading("10. short-span streams (short_span_limit = S)")
    short = phase_short_span(
        device, uni, ycsb,
        {"outs": uniform.pop("outs"), "final": uniform.pop("final"),
         "ms": uniform["ms_per_batch"]},
        {"outs": classic.pop("outs"), "maps": classic.pop("maps")},
        {"outs0": sharded.pop("outs0"), "state0": sharded.pop("state0")})
    ledger.update(short.pop("ledger"))
    heading("11. reduced-shape stream vs ConflictOracle")
    phase_oracle(device)
    heading("12. the staging pipeline (pinned, a copy stream)")
    pipeline = phase_pipeline(device, uni, uniform_ref, classic_ref)
    heading("13. the Resolver role")
    resolver = phase_resolver(device, role_results)
    heading("14. the wire resolver (four resolver processes)")
    wire = phase_wire(role, role_results, resolver)
    heading("15. the commit path (three port processes, YCSB A)")
    card = devmod.nvidia_smi_name_power(device.index or 0)
    commit = phase_commit_path(card)
    check_commit_launches(commit, uniform, card)
    heading("16. the simulated cluster (open_cluster, YCSB A)")
    sim = phase_sim_cluster(card, uniform)
    heading("17. the wire cluster under its controller (monitor, kill -9)")
    parity = recovery_parity_on_card(device)
    log(f"  recovery parity: the card's ResolverRole decided the in-flight "
        f"set {parity['decisions']}, as the sim recovery does")
    wire_cluster = phase_wire_cluster(card, uniform)
    wire_cluster["recovery_parity"] = parity
    heading("18. the simulation ensemble on the card (device seeds, faults)")
    ensemble = phase_ensemble(card)
    heading("19. the features beside the commit path (DR, regions, tenants, "
            "restore, layers)")
    features = phase_features(card, uniform)
    heading("20. the sealed commit path over mutual TLS, tenant tokens")
    sealed = phase_sealed(card, uniform, commit)
    log(f"== done in {time.perf_counter() - T_START:.1f} s; profiler "
        f"sessions taken again {len(RETAKES)}, sessions that lost spin "
        f"kernels {len(WARM_LOST)} (at most {max(WARM_LOST, default=0)} of "
        f"{WARM_KERNELS + LATE_KERNELS})")

    # each kernel's launches on the path that runs it, counted from 0
    path_of = {"read_dedup": hot, "sweep_ranks": scan,
               **{name: classic for name in CLASSIC_ONLY},
               **{name: sharded for name in SHARDED_ONLY},
               **{name: short["uniform"] for name in SHORT_SPAN_ONLY},
               **{name: short["classic"] for name in CROSS_SPAN_ONLY}}
    rows = []
    for name, info in kernels.KERNELS.items():
        launches = (0 if name in OFF_PATH
                    else path_of.get(name, uniform)["launches"][name])
        rows.append(dict(name=name, route="cuda", source=info.source,
                         replaces=info.replaces, launches=launches,
                         **ledger[name]))
    streams = {}
    for tag, st in (("uniform", uniform), ("hot_key", hot),
                    ("range_scan", scan), ("classic_uniform", classic),
                    ("classic_hot_key", classic_hot),
                    ("resolver_role", role), ("sharded_uniform", sharded),
                    ("short_span_uniform", short.pop("uniform")),
                    ("short_span_classic", short.pop("classic")),
                    ("pipelined_uniform", pipeline.pop("uniform")),
                    ("pipelined_classic", pipeline.pop("classic"))):
        streams[tag] = {k: v for k, v in st.items() if k != "launches"}
        streams[tag]["launches_per_batch"] = {
            k: n / st["batches"] for k, n in st["launches"].items()}
        streams[tag]["kernel_bound_ms_per_batch"] = device_bound_per_batch(
            st)
    streams["short_span"] = short
    streams["staging"] = pipeline
    streams["resolver"] = {tag: {k: v for k, v in st.items()
                                 if k not in ("launches", "launch_bytes")}
                           for tag, st in resolver.items()}
    streams["wire"] = wire
    streams["commit_path"] = commit
    streams["sim_cluster"] = sim
    streams["wire_cluster"] = wire_cluster
    streams["ensemble"] = ensemble
    streams["features"] = features
    streams["sealed"] = sealed
    print(json.dumps({"streams": streams, "torch_ops": torch_ops,
                      "read_spans": read_spans,
                      "profiler_retakes": RETAKES,
                      "profiler_spin_kernels_lost": WARM_LOST}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(devmod.nvidia_smi_name_power(device.index or 0), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
