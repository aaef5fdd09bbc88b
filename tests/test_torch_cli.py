"""The port's cli (`cli.py`: `CliSession` and every `_cmd_*`) held
against the JAX package's on the CPU.

Twins (tests/twins.py) of tests/test_backup_cli.py's cli tests and its
versionstamp test (its snapshot, point-in-time and cli backup tests are
tests/test_torch_restore.py's), written once against a package
namespace and run through both pairs of backends: writemode, get,
getrange, set, clear, status and status json, an unknown command,
tenant, setknob, getknobs, moveshard, consistencycheck, watch,
clearrange and rebalance. Every output is equal to the JAX package's but
status's resolver_backend line, which names each package's backend.
"""

from __future__ import annotations

import json

import pytest

from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads
from twins import JAX, PAIR_IDS, PAIRS, PORT, check_twin, ns

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

TWINS = {}


def twin(fn):
    TWINS[fn.__name__] = fn
    return fn


def _backend_line(w, text: str) -> str:
    """status's text with its resolver_backend line checked against the
    run's backend and left out."""
    lines = text.split("\n")
    (i,) = [n for n, ln in enumerate(lines) if "resolver_backend" in ln]
    assert lines[i] == f"  resolver_backend    - {w.backend}", lines[i]
    return "\n".join(lines[:i] + lines[i + 1:])


@twin
def cli_commands(w):
    sched, cluster, db = w.open(n_storage=2)
    cli = w.P.cli.CliSession(cluster, db)
    cmds = ["set k v", "writemode on", "set k v", "get k", "getrange a z",
            "clear k", "get k", "status", "status json", "bogus",
            "writemode maybe"]

    async def body():
        return [await cli.run_command(c) for c in cmds]

    out = w.run(sched, body())
    (blocked, _on, set_ok, get_ok, rng, clr, gone, status, status_json,
     unknown, bad_mode) = out
    assert blocked.startswith("ERROR: writemode") and set_ok == "Committed"
    assert get_ok == "`k' is `v'" and "`k' is `v'" in rng
    assert clr == "Committed" and gone == "`k': not found"
    assert unknown.startswith("ERROR: unknown command")
    assert bad_mode == "ERROR: writemode [on|off]"
    conf = json.loads(status_json)["cluster"]["configuration"]
    assert conf.pop("resolver_backend") == w.backend
    out[7] = _backend_line(w, status)
    out[8] = conf
    return out


@twin
def cli_tenant_knob_consistency_move(w):
    sched, cluster, db = w.open(n_storage=2)
    cli = w.P.cli.CliSession(cluster, db)

    async def body():
        out = [await cli.run_command("tenant create projA")]
        await cli.run_command("writemode on")
        for c in ("tenant create projA", "tenant list", "setknob MAX_THING 42",
                  "setknob NAME text", "getknobs", "set mk v",
                  "moveshard mk ml 1"):
            out.append(await cli.run_command(c))
        await sched.delay(0.2)
        for c in ("consistencycheck", "tenant delete projA", "tenant list",
                  "tenant rename"):
            out.append(await cli.run_command(c))
        return out

    out = w.run(sched, body())
    (refused, created, listed, knob_set, text_knob, knobs, _set, moved, check,
     deleted, empty, bad) = out
    assert refused.startswith("ERROR: writemode") and "created" in created
    assert listed == "projA" and knob_set == "Knob MAX_THING set"
    assert "MAX_THING = 42" in knobs and "NAME = 'text'" in knobs
    assert moved.startswith("Moved") and check.startswith("Consistency check")
    assert "deleted" in deleted and empty == "No tenants"
    assert bad.startswith("ERROR: tenant")
    return out


@twin
def cli_watch_clearrange_rebalance(w):
    """The commands tests/test_backup_cli.py leaves out: watch (fired by a
    write from another task), clearrange and rebalance."""
    sched, cluster, db = w.open(n_storage=2, n_resolvers=2)
    cli = w.P.cli.CliSession(cluster, db)

    async def body():
        await cli.run_command("writemode on")
        out = [await cli.run_command("set w 1")]

        async def writer():
            await sched.delay(0.05)
            txn = db.create_transaction()
            txn.set(b"w", b"2")
            await txn.commit()

        t = sched.spawn(writer())
        out.append(await cli.run_command("watch w"))
        await t.done
        for c in ("set r1 a", "set r2 b", "clearrange r1 r3", "getrange r r9",
                  "rebalance", "writemode off", "clearrange a z"):
            out.append(await cli.run_command(c))
        return out

    out = w.run(sched, body())
    assert out[1].startswith("`w' changed at version")
    assert out[5] == "Range is empty"
    assert out[6] in ("Balanced", "Moved a resolver boundary")
    assert out[8].startswith("ERROR: writemode")
    return out


@twin
def versionstamped_key_and_value(w):
    sched, cluster, db = w.open(n_storage=2)

    async def body():
        txn = db.create_transaction()
        txn.set_versionstamped_key(b"log/", b"/end", b"payload")
        txn.set_versionstamped_value(b"last", b"at=")
        v = await txn.commit()
        stamp = txn.versionstamp
        txn = db.create_transaction()
        return (v, stamp, await txn.get_range(b"log/", b"log0"),
                await txn.get(b"last"))

    v, stamp, items, last = out = w.run(sched, body())
    assert len(stamp) == 10 and int.from_bytes(stamp[:8], "big") == v
    assert items == [(b"log/" + stamp + b"/end", b"payload")]
    assert last == b"at=" + stamp
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", list(TWINS))
def test_twin(name, pair):
    check_twin(TWINS[name], pair)


def test_twins_cover_their_sources():
    """tests/test_backup_cli.py's tests are twinned here or in
    tests/test_torch_restore.py, and every command has a handler."""
    import ast
    from pathlib import Path

    here = Path(__file__).parent
    tree = ast.parse((here / "test_backup_cli.py").read_text())
    names = {n.name.removeprefix("test_") for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    restore = ast.parse((here / "test_torch_restore.py").read_text())
    there = {n.name for n in restore.body if isinstance(n, ast.FunctionDef)}
    assert names <= set(TWINS) | there, sorted(names - set(TWINS) - there)
    J, P = ns(JAX).cli.CliSession, ns(PORT).cli.CliSession
    assert sorted(n for n in vars(P) if n.startswith("_cmd_")) == \
        sorted(n for n in vars(J) if n.startswith("_cmd_"))
