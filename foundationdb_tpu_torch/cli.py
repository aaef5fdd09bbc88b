"""fdbcli-equivalent: interactive admin commands against a cluster.

Behavioral mirror of `fdbcli/` (one command per module there; one handler
here): status (human + json), point/range reads and writes guarded by
writemode, backup/restore, rebalance, and watch — driven either
programmatically (`run_command`) or as a REPL on a real scheduler.

The port's own copy of foundationdb_tpu.cli.
"""

from __future__ import annotations

import json
import shlex

from foundationdb_tpu_torch.cluster.status import cluster_status


class CliSession:
    def __init__(self, cluster, db):
        self.cluster = cluster
        self.db = db
        self.write_mode = False

    async def run_command(self, line: str) -> str:
        """Execute one command line; returns the output text."""
        parts = shlex.split(line)
        if not parts:
            return ""
        cmd, *args = parts
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            return f"ERROR: unknown command `{cmd}`"
        return await handler(args)

    # -- commands ---------------------------------------------------------

    async def _cmd_status(self, args) -> str:
        st = cluster_status(self.cluster)
        if args and args[0] == "json":
            return json.dumps(st, indent=2)
        c = st["cluster"]
        w = c["workload"]["transactions"]
        return (
            "Configuration:\n"
            f"  commit_proxies      - {c['configuration']['commit_proxies']}\n"
            f"  resolvers           - {c['configuration']['resolvers']}\n"
            f"  storage_servers     - {c['configuration']['storage_servers']}\n"
            f"  resolver_backend    - {c['configuration']['resolver_backend']}\n"
            "Workload:\n"
            f"  started             - {w['started']}\n"
            f"  committed           - {w['committed']}\n"
            f"  conflicted          - {w['conflicted']}\n"
            f"  live version        - {c['live_committed_version']}\n"
        )

    async def _cmd_writemode(self, args) -> str:
        if args and args[0] in ("on", "off"):
            self.write_mode = args[0] == "on"
            return ""
        return "ERROR: writemode [on|off]"

    def _need_write(self):
        if not self.write_mode:
            return "ERROR: writemode must be enabled to modify the database"
        return None

    async def _cmd_get(self, args) -> str:
        txn = self.db.create_transaction()
        v = await txn.get(args[0].encode())
        if v is None:
            return f"`{args[0]}': not found"
        return f"`{args[0]}' is `{v.decode('latin-1')}'"

    async def _cmd_getrange(self, args) -> str:
        txn = self.db.create_transaction()
        limit = int(args[2]) if len(args) > 2 else 25
        items = await txn.get_range(args[0].encode(), args[1].encode(), limit=limit)
        lines = [f"`{k.decode('latin-1')}' is `{v.decode('latin-1')}'"
                 for k, v in items]
        return "\n".join(lines) if lines else "Range is empty"

    async def _cmd_set(self, args) -> str:
        if err := self._need_write():
            return err
        txn = self.db.create_transaction()
        txn.set(args[0].encode(), args[1].encode())
        await txn.commit()
        return "Committed"

    async def _cmd_clear(self, args) -> str:
        if err := self._need_write():
            return err
        txn = self.db.create_transaction()
        txn.clear(args[0].encode())
        await txn.commit()
        return "Committed"

    async def _cmd_clearrange(self, args) -> str:
        if err := self._need_write():
            return err
        txn = self.db.create_transaction()
        txn.clear_range(args[0].encode(), args[1].encode())
        await txn.commit()
        return "Committed"

    async def _cmd_watch(self, args) -> str:
        txn = self.db.create_transaction()
        fut = await txn.watch(args[0].encode())
        v = await fut
        return f"`{args[0]}' changed at version {v}"

    async def _cmd_rebalance(self, args) -> str:
        moved = self.cluster.balancer.rebalance_once()
        return "Moved a resolver boundary" if moved else "Balanced"

    async def _cmd_backup(self, args) -> str:
        from foundationdb_tpu_torch.cluster.backup import BackupAgent, DirBackupContainer

        agent = BackupAgent(self.db, DirBackupContainer(args[0]))
        version = await agent.snapshot()
        return f"Snapshot complete at version {version}"

    async def _cmd_restore(self, args) -> str:
        if err := self._need_write():
            return err
        from foundationdb_tpu_torch.cluster.backup import BackupAgent, DirBackupContainer

        agent = BackupAgent(self.db, DirBackupContainer(args[0]))
        version = await agent.restore()
        return f"Restored to version {version}"

    async def _cmd_tenant(self, args) -> str:
        from foundationdb_tpu_torch.cluster import tenant as T

        sub = args[0]
        if sub == "create":
            if err := self._need_write():
                return err
            await T.create_tenant(self.db, args[1].encode())
            return f"The tenant `{args[1]}' has been created"
        if sub == "delete":
            if err := self._need_write():
                return err
            await T.delete_tenant(self.db, args[1].encode())
            return f"The tenant `{args[1]}' has been deleted"
        if sub == "list":
            names = await T.list_tenants(self.db)
            return "\n".join(n.decode("latin-1") for n in names) or "No tenants"
        return "ERROR: tenant [create|delete|list] ..."

    async def _cmd_setknob(self, args) -> str:
        if err := self._need_write():
            return err
        from foundationdb_tpu_torch.cluster.config_db import set_knob
        import ast

        try:
            value = ast.literal_eval(args[1])
        except (ValueError, SyntaxError):
            value = args[1]
        await set_knob(self.db, args[0], value)
        return f"Knob {args[0]} set"

    async def _cmd_getknobs(self, args) -> str:
        from foundationdb_tpu_torch.cluster.config_db import read_overrides

        ov = await read_overrides(self.db)
        return "\n".join(f"{k} = {v!r}" for k, v in sorted(ov.items())) or \
            "No overrides"

    async def _cmd_consistencycheck(self, args) -> str:
        from foundationdb_tpu_torch.cluster.consistency import check_cluster

        stats = check_cluster(self.cluster)
        return (f"Consistency check OK: {stats['keys_checked']} keys, "
                f"{stats['shards_checked']} shards, "
                f"{stats['replica_compares']} replica comparisons")

    async def _cmd_moveshard(self, args) -> str:
        if err := self._need_write():
            return err
        begin, end = args[0].encode(), args[1].encode()
        dest = tuple(int(x) for x in args[2].split(","))
        await self.cluster.data_distributor.move_shard(begin, end, dest)
        return f"Moved [{args[0]}, {args[1]}) to team {dest}"
