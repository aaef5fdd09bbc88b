"""The commit timeline around the elastic recruit, for the JAX package's
elasticity drill (`scripts/elasticity_drill.py`) and the port's
(`foundationdb_tpu_torch/drills/elasticity.py`), ON direction, on the CPU.

Each package's `ClusterClient` is wrapped for the run: `connect` marks the
drill's start, `commit` records when each acknowledged commit returned,
and `topology` records when the drill's watcher first saw the cluster
recovering, each change of the cluster's (state, epoch, resolvers), and
when it first saw two resolvers fully recovered (the recruit time the
drill's windows hang on). It prints, for each drill, the drill's own
result (plateau, post-recruit goodput, scale), those changes, the
commits in each 0.5 s bin from 8 s before the recruit to 8 s after it,
and the longest gap between commits inside the plateau window (the 3.5 s
before the recruit).

    env PYTHONPATH= JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 \\
        python tests/elastic_timeline.py [--port-backend cpu|native] \\
        [--only jax|port] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BIN_S = 0.5
SPAN_S = 8.0
PLATEAU_S = 3.5


def _wrap(client_cls, gen_state_recovered: str, rec: dict):
    """Wrap `client_cls`'s connect, commit and topology to fill `rec`;
    returns the originals."""
    orig = {n: getattr(client_cls, n)
            for n in ("connect", "commit", "topology")}

    async def connect(self, *a, **k):
        out = await orig["connect"](self, *a, **k)
        if rec["t0"] is None:
            rec["t0"] = time.monotonic()
        return out

    async def commit(self, *a, **k):
        out = await orig["commit"](self, *a, **k)
        rec["commits"].append(time.monotonic())
        return out

    async def topology(self, *a, **k):
        topo = await orig["topology"](self, *a, **k)
        now = time.monotonic()
        n_res = sum(1 for e in topo["roles"].values()
                    if e["kind"] == "resolver")
        if topo["state"] != gen_state_recovered:
            rec["recovering"].append(now)
        seen = (topo["state"], topo["epoch"], n_res)
        if not rec["states"] or rec["states"][-1][1:] != seen:
            rec["states"].append((now, *seen))
        if rec["recruit"] is None and n_res > 1 and (
                topo["state"] == gen_state_recovered):
            rec["recruit"] = now
        return topo

    client_cls.connect = connect
    client_cls.commit = commit
    client_cls.topology = topology
    return orig


def run_drill(which: str, args) -> dict:
    """One ON direction of `which` ("jax" or "port") with the timeline
    recorded."""
    if which == "jax":
        sys.path.insert(0, str(REPO / "scripts"))
        import elasticity_drill as drill
        from foundationdb_tpu.cluster import generation as gen
        from foundationdb_tpu.cluster import multiprocess as mp
    else:
        from foundationdb_tpu_torch.cluster import generation as gen
        from foundationdb_tpu_torch.cluster import multiprocess as mp
        from foundationdb_tpu_torch.drills import elasticity as drill
    rec = {"t0": None, "commits": [], "recovering": [], "recruit": None,
           "states": []}
    orig = _wrap(mp.ClusterClient, gen.FULLY_RECOVERED, rec)
    try:
        res = asyncio.run(drill._run_direction_gated(True, args))
    finally:
        for name, fn in orig.items():
            setattr(mp.ClusterClient, name, fn)
    return summarize(which, res, rec)


def summarize(which: str, res: dict, rec: dict) -> dict:
    """The drill's result and the commit timeline around the recruit."""
    out = {"drill": which, "result": res}
    if rec["recruit"] is None:
        out["bins"] = None
        return out
    r = rec["recruit"]
    t = [c - r for c in rec["commits"]]
    n_bins = int(2 * SPAN_S / BIN_S)
    bins = []
    for i in range(n_bins):
        lo = -SPAN_S + i * BIN_S
        bins.append([round(lo, 2), sum(1 for x in t if lo <= x < lo + BIN_S)])
    window = sorted(x for x in t if -PLATEAU_S <= x < 0)
    edges = [-PLATEAU_S] + window + [0.0]
    recovering = [x - r for x in rec["recovering"] if -SPAN_S <= x - r <= 0]
    # the recruited topology's rate: from the recruit to the cluster's
    # next change (the controller's scale-down), or the run's last commit
    after = [st[0] - r for st in rec["states"] if st[0] > r]
    hi = min(after) if after else max(t)
    held = sum(1 for x in t if 0 <= x < hi) / hi if hi > 0 else 0.0
    out.update(
        recruit_at_s=round(r - rec["t0"], 3),
        first_recovering_seen_s=(round(min(recovering), 3)
                                 if recovering else None),
        states=[(round(t - r, 3), *rest) for t, *rest in rec["states"]],
        recruited_held_s=round(hi, 3),
        recruited_txn_s=round(held, 1),
        recruited_over_plateau=(round(held / res["plateau_txn_s"], 3)
                                if res["plateau_txn_s"] else None),
        plateau_window_commits=len(window),
        plateau_window_longest_gap_s=round(
            max(b - a for a, b in zip(edges, edges[1:])), 3),
        bins=bins)
    return out


def show(out: dict) -> None:
    res = out["result"]
    print(f"== {out['drill']}: plateau {res['plateau_txn_s']} txn/s, "
          f"post {res['post_txn_s']} txn/s, scale {res['scale']}, "
          f"recruited {res['recruited']}", flush=True)
    if out["bins"] is None:
        print("   no recruit seen", flush=True)
        return
    print(f"   recruit seen at t+{out['recruit_at_s']} s; the watcher saw "
          f"the cluster recovering from {out['first_recovering_seen_s']} s "
          f"before it; {out['plateau_window_commits']} commits in the "
          f"plateau window, its longest gap "
          f"{out['plateau_window_longest_gap_s']} s; the recruited "
          f"topology held {out['recruited_held_s']} s at "
          f"{out['recruited_txn_s']} txn/s, "
          f"{out['recruited_over_plateau']}x the plateau", flush=True)
    print("   the cluster's (state, epoch, resolvers) as the watcher saw "
          "them change, from the recruit: "
          + "; ".join(f"{t:+.2f} s {st} {ep} {n}"
                      for t, st, ep, n in out["states"]), flush=True)
    print("   commits a 0.5 s bin, from the recruit: "
          + " ".join(f"{lo:+.1f}:{n}" for lo, n in out["bins"]), flush=True)


def main(argv=None) -> int:
    from foundationdb_tpu_torch.drills import elasticity

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-backend", default="cpu",
                    choices=("cpu", "native"))
    ap.add_argument("--only", choices=("jax", "port"), default=None)
    ap.add_argument("--json-out", default=None)
    ns = ap.parse_args(argv)
    outs = []
    for which in ("jax", "port"):
        if ns.only not in (None, which):
            continue
        args = elasticity.parser().parse_args(
            ["--smoke", "--backend", ns.port_backend, "--no-perf"])
        elasticity.smoke_args(args)
        args.mode_label = "smoke"
        out = run_drill(which, args)
        show(out)
        outs.append(out)
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            json.dump(outs, f)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
