"""fdbmonitor analog: supervise role processes, restart them on death
(the port's own copy of foundationdb_tpu.cluster.monitor).

The reference ships `fdbmonitor` (fdbmonitor/fdbmonitor.cpp, 1,944 LoC):
a small non-Flow supervisor that reads `foundationdb.conf`, launches the
configured fdbserver processes, restarts them with backoff when they die,
and re-reads the conf on SIGHUP. Same contract here for the multiprocess
roles:

* conf: an INI-like file with one `[role.<name>]` section per process —
  role kind, socket address, optional data dir / backend / tlog address
  (for storage catch-up on restart).
* supervision loop: poll children; a dead child is restarted after an
  exponential backoff (reset once it stays up), exactly fdbmonitor's
  delay discipline.
* SIGHUP (or `reload()`): re-read the conf — new sections launch,
  removed sections are stopped.

Used programmatically (`Monitor(conf_path).run_forever()`) or as
`python -m foundationdb_tpu_torch.cluster.monitor <conf>`.

Against the JAX module: a section's `backend` defaults to "cuda" (JAX:
"native"), and its `device` (none: the card; `cpu`: the plain
versions) reaches a resolver's or a worker's process (`--device`), so a
worker's resolvers run on it.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import signal
import sys
import time
from typing import Optional

from foundationdb_tpu_torch.cluster.multiprocess import spawn_role


@dataclasses.dataclass
class RoleSpec:
    name: str
    kind: str  # resolver | tlog | storage | ratekeeper | worker | controller
    socket_dir: str
    index: int = 0
    backend: str = "cuda"
    data_dir: Optional[str] = None
    tlog_address: Optional[str] = None
    storage_engine: str = "memory"
    encrypt: bool = False
    #: ratekeeper: comma list of peer role sockets whose StatusRequest
    #: sensors feed the admission law
    peers: Optional[str] = None
    #: worker/ratekeeper: the cluster controller's socket — under the
    #: controller, the monitor is the DUMB process babysitter (restart
    #: dead processes, nothing else); recruitment and recovery belong
    #: to the controller (cluster/multiprocess.py ClusterControllerRole)
    controller: Optional[str] = None
    #: controller: JSON file with the declarative topology
    cluster_conf: Optional[str] = None
    #: controller: persisted-epoch file (the coordinated-state analog)
    state_file: Optional[str] = None
    #: resolver / worker: the device of the conflict sets it builds
    #: (None: the card; "cpu": the plain versions)
    device: Optional[str] = None

    @property
    def address(self) -> str:
        return os.path.join(self.socket_dir, f"{self.kind}{self.index}.sock")


def parse_conf(path: str) -> dict[str, RoleSpec]:
    """Parse the foundationdb.conf-style role file."""
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f)
    specs: dict[str, RoleSpec] = {}
    addresses: dict[str, str] = {}
    for section in cp.sections():
        if not section.startswith("role."):
            continue
        name = section[len("role."):]
        sec = cp[section]
        spec = RoleSpec(
            name=name,
            kind=sec["kind"],
            socket_dir=sec["socket_dir"],
            index=sec.getint("index", 0),
            backend=sec.get("backend", "cuda"),
            data_dir=sec.get("data_dir", None),
            tlog_address=sec.get("tlog_address", None),
            storage_engine=sec.get("storage_engine", "memory"),
            encrypt=sec.getboolean("encrypt", False),
            peers=sec.get("peers", None),
            controller=sec.get("controller", None),
            cluster_conf=sec.get("cluster_conf", None),
            state_file=sec.get("state_file", None),
            device=sec.get("device", None),
        )
        if spec.address in addresses:
            raise ValueError(
                f"[role.{name}] and [role.{addresses[spec.address]}] share "
                f"socket {spec.address}: give them distinct index values"
            )
        addresses[spec.address] = name
        specs[name] = spec
    return specs


@dataclasses.dataclass
class _Child:
    spec: RoleSpec
    proc: object  # RoleProcess
    started_at: float
    backoff: float
    restart_at: Optional[float] = None  # set while waiting out a backoff


class Monitor:
    """Supervises one conf's role processes (fdbmonitor's loop)."""

    INITIAL_BACKOFF = 0.2
    MAX_BACKOFF = 30.0
    #: uptime after which the backoff resets (fdbmonitor's restart delay
    #: resets once the child proves stable)
    STABLE_AFTER = 5.0

    def __init__(self, conf_path: str, *, log=print):
        self.conf_path = conf_path
        self.log = log
        self.children: dict[str, _Child] = {}
        self.restarts: dict[str, int] = {}
        self.death_notifies = 0
        self._stop = False
        self._want_reload = False
        self._child_died = False  # SIGCHLD flag: poll now, don't wait

    # -- lifecycle -------------------------------------------------------

    def start_all(self) -> None:
        for name, spec in parse_conf(self.conf_path).items():
            if name not in self.children:
                self._launch(spec)

    def _launch(self, spec: RoleSpec) -> None:
        # a stale socket from a dead child blocks rebinding
        try:
            os.unlink(spec.address)
        except FileNotFoundError:
            pass
        proc = spawn_role(
            spec.kind,
            spec.socket_dir,
            backend=spec.backend,
            index=spec.index,
            data_dir=spec.data_dir,
            tlog_address=spec.tlog_address,
            storage_engine=spec.storage_engine,
            # without this, a supervised restart of an encrypted store
            # would crash-loop on the ENCRYPTION_MODE marker
            encrypt=spec.encrypt,
            peers=spec.peers.split(",") if spec.peers else None,
            controller=spec.controller,
            # the conf NAME is the worker's stable identity: a restarted
            # worker re-registers as itself and the controller sees the
            # same worker with an empty role map (role died with it)
            worker_id=spec.name if spec.kind == "worker" else None,
            cluster_conf=spec.cluster_conf,
            state_file=spec.state_file,
            device=spec.device,
        )
        self.children[spec.name] = _Child(
            spec=spec, proc=proc, started_at=time.monotonic(),
            backoff=self.INITIAL_BACKOFF,
        )
        self.log(f"[monitor] launched {spec.name} ({spec.kind}) "
                 f"pid={proc.proc.pid}")

    def poll_once(self) -> None:
        """One supervision pass: restart whatever died (with backoff).

        Never blocks: a dead child gets a restart DEADLINE and is
        relaunched on a later pass once its backoff elapses, so one
        crash-looping role cannot stall supervision of the others (or
        signal handling) — fdbmonitor's per-process delay discipline.
        """
        now = time.monotonic()
        for name, child in list(self.children.items()):
            if child.restart_at is not None:
                if now >= child.restart_at:
                    self.restarts[name] = self.restarts.get(name, 0) + 1
                    backoff = min(child.backoff * 2, self.MAX_BACKOFF)
                    self._launch(child.spec)
                    self.children[name].backoff = backoff
                continue
            rc = child.proc.proc.poll()
            if rc is None:
                if now - child.started_at > self.STABLE_AFTER:
                    child.backoff = self.INITIAL_BACKOFF
                continue
            self.log(f"[monitor] {name} died rc={rc}; restarting in "
                     f"{child.backoff:.1f}s")
            # PUSH-ON-DEATH: tell the controller NOW — one
            # supervision poll of detection latency instead of the
            # controller waiting out HEARTBEAT_MISSES status polls
            self._notify_death(child.spec, rc)
            child.restart_at = now + child.backoff

    def _notify_death(self, spec: RoleSpec, rc) -> None:
        """Best-effort WorkerDeath push to the controller the dead
        worker was registered with. Failure degrades to the heartbeat
        backstop (a dead controller will learn from beacons once the
        monitor restarts it); the call is bounded so a hung controller
        cannot stall supervision of the other children."""
        if not spec.controller or spec.kind == "controller":
            return
        import asyncio
        import json

        from foundationdb_tpu_torch.cluster import multiprocess as mp

        async def _send():
            conn = mp.transport.RpcConnection(spec.controller)
            await conn.connect(retries=1, delay=0.05)
            try:
                # classification boundary is _notify_death's outer
                # `except Exception` around asyncio.run(_send()):
                # death-push failure is logged, never fatal
                await conn.call(  # flowcheck: ignore[wire.unclassified-error]
                    mp.TOKEN_WORKER_DEATH,
                    mp.WorkerDeath(payload=json.dumps({
                        "worker_id": spec.name,
                        "kind": spec.kind,
                        "address": spec.address,
                        "rc": rc,
                    })),
                    timeout=2.0,
                )
            finally:
                await conn.close()

        try:
            asyncio.run(asyncio.wait_for(_send(), 2.5))
            self.death_notifies += 1
            self.log(f"[monitor] pushed {spec.name} death to controller")
        except Exception as e:
            self.log(f"[monitor] death push failed (heartbeat backstop "
                     f"will catch it): {e!r}")

    def reload(self) -> None:
        """Re-read the conf: launch new sections, stop removed ones, and
        RESTART sections whose spec changed (fdbmonitor restarts changed
        processes; a crash-restart must never resurrect a stale spec)."""
        specs = parse_conf(self.conf_path)
        for name in [n for n in self.children if n not in specs]:
            self.log(f"[monitor] {name} removed from conf; stopping")
            self.children.pop(name).proc.stop()
        for name, spec in specs.items():
            if name not in self.children:
                self._launch(spec)
            elif self.children[name].spec != spec:
                self.log(f"[monitor] {name} conf changed; restarting")
                self.children.pop(name).proc.stop()
                self._launch(spec)

    def stop_all(self) -> None:
        self._stop = True
        for child in self.children.values():
            child.proc.stop()
        self.children.clear()

    def run_forever(self, *, poll_interval: float = 0.25) -> None:
        """Supervision loop. Signal handlers only SET FLAGS; the loop acts
        on them between passes — mutating children from a handler mid-pass
        could leak an orphan child or resurrect a removed role
        (fdbmonitor serializes signals into its main loop the same way).
        """
        self.start_all()
        signal.signal(
            signal.SIGHUP,
            lambda *_: setattr(self, "_want_reload", True),
        )
        signal.signal(
            signal.SIGTERM, lambda *_: setattr(self, "_stop", True)
        )
        # SIGCHLD: a dead child triggers an IMMEDIATE supervision pass
        # (the push-on-death latency is then one signal delivery, not a
        # poll interval). The handler only sets a flag — fdbmonitor's
        # serialize-signals-into-the-loop discipline.
        signal.signal(
            signal.SIGCHLD,
            lambda *_: setattr(self, "_child_died", True),
        )
        try:
            while not self._stop:
                if self._want_reload:
                    self._want_reload = False
                    try:
                        self.reload()
                    except Exception as e:
                        # a bad conf must not kill the monitor: keep
                        # supervising with the old one (fdbmonitor's
                        # behavior on an unparseable reload)
                        self.log(f"[monitor] reload failed, keeping old "
                                 f"conf: {e}")
                self._child_died = False
                self.poll_once()
                # sliced sleep: SIGHUP/SIGTERM/SIGCHLD all cut it short
                deadline = time.monotonic() + poll_interval
                while (
                    time.monotonic() < deadline
                    and not (self._stop or self._want_reload
                             or self._child_died)
                ):
                    time.sleep(0.02)
        finally:
            self.stop_all()  # never orphan children, even on a crash


def main() -> None:
    if len(sys.argv) != 2:
        print("usage: python -m foundationdb_tpu_torch.cluster.monitor <conf>",
              file=sys.stderr)
        sys.exit(2)
    Monitor(sys.argv[1]).run_forever()


if __name__ == "__main__":
    main()
