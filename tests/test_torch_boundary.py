"""The port's boundaries: what it imports, where it runs, what it launches.

* no module of foundationdb_tpu_torch (its drills too), and not
  chip_smoke.py, imports jax or foundationdb_tpu (an AST scan, and an
  import in a subprocess where importing jax fails); no data file of the
  port (the soak specs, the probe manifest) names the JAX package, JAX or
  its "tpu-force" backend;
* `make_conflict_set(cfg)` without a card and without device="cpu"
  raises instead of running on the CPU; every variant knob builds;
* a kernel wrapper given CPU tensors takes its plain version and leaves
  every launch count at 0;
* every kernel in the ledger has its CUDA source, and every source says
  which JAX program it replaces.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import kernels, make_conflict_set
from foundationdb_tpu_torch.config import KernelConfig
from foundationdb_tpu_torch.ops import delta as D
from foundationdb_tpu_torch.ops import group as G
from foundationdb_tpu_torch.ops import history as H
from foundationdb_tpu_torch.ops import keys as K
from foundationdb_tpu_torch.ops import rangemax as R
from foundationdb_tpu_torch.ops import segtree as S
from foundationdb_tpu_torch.parallel import sharding as SH
from foundationdb_tpu_torch.testing.threads import cap_intra_op_threads

# this process's share of the host's cores (testing/threads.py)
cap_intra_op_threads()

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "foundationdb_tpu_torch"
CFG = KernelConfig(max_key_bytes=8, max_txns=16, max_reads=32,
                   max_writes=32, history_capacity=64, delta_capacity=64)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "foundationdb_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_drills():
    scanned = {p.relative_to(PORT).parts[0] for p in _port_files()[:-1]}
    assert {"drills", "testing", "cluster"} <= scanned


def _port_data_files():
    return sorted(p for p in PORT.rglob("*")
                  if p.suffix in (".json", ".toml")
                  and "build" not in p.relative_to(PORT).parts)


@pytest.mark.parametrize("path", _port_data_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_data_files_name_only_the_port(path):
    text = path.read_text()
    assert not re.search(r"foundationdb_tpu(?!_torch)", text)
    assert "tpu-force" not in text and "jax" not in text.lower()


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py")
    )
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "foundationdb_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_conflict_set(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_conflict_set(CFG, "cuda", device="cuda")
    assert make_conflict_set(CFG, "cuda", device="cpu").device.type == "cpu"


def test_variant_knobs_are_refused():
    """No variant knob is refused any more: the short-span ops (once the
    last refused variant) build on the tiered, classic and sharded
    paths, and so do the classic single-tier path (no delta tier), the
    latch, dedup, sweep and spill knobs and the sharded path
    (tests/test_torch_short_span.py, tests/test_torch_classic.py,
    tests/test_torch_variants.py, tests/test_torch_sharding.py)."""
    for kw in ({"short_span_limit": 4},
               {"short_span_limit": 4, "delta_capacity": 0},
               {"short_span_limit": 4, "n_shards": 2}):
        cs = make_conflict_set(CFG.scaled(**kw), "cuda", device="cpu")
        assert cs.config.short_span_limit == 4
    for kw in ({"fixpoint_latch": True}, {"dedup_reads": 8},
               {"range_sweep": True}, {"delta_spill": True},
               {"delta_capacity": 0},
               {"delta_capacity": 0, "fixpoint_latch": True},
               {"n_shards": 2}):
        make_conflict_set(CFG.scaled(**kw), "cuda", device="cpu")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(kernels, "launch", no_launch)
    kernels.reset_counts()
    rng = np.random.default_rng(0)
    keys = torch.sort(torch.from_numpy(
        rng.integers(0, 1000, 64).astype(np.int32))).values
    keys = torch.stack([keys, torch.full_like(keys, 4)], 1)
    q = keys[::3].contiguous()
    K.searchsorted(keys, q, side="left")
    K.searchsorted(keys, q, side="both")
    vals = torch.from_numpy(rng.integers(0, 99, 64).astype(np.int32))
    tab = R.build(vals, op="max")
    lo = torch.arange(32, dtype=torch.int32)
    G._sorted_counts(lo, 40)
    R.query(tab, lo, lo + 5, op="min")
    S.min_cover(64, lo, lo + 3, lo)
    hist = H.VersionHistory(keys, vals, H.VERSION_NEG, torch.tensor(False))
    H.query_reads_vmax(hist, q, q, tab)
    H.merge_maps(keys, vals, keys[:8], vals[:8], floor=0, capacity=64)
    live = torch.ones((q.shape[0],), dtype=torch.bool)
    D.sweep_read_ranks(keys, q, q, live)
    D.dedup_vmax(hist, tab, q, q, live, 8)
    R.query2(R.build2(vals, op="max"), lo, lo + 40, op="max")
    G.seg_fold(vals, lo, lo + 3, lo > 4, 7)
    g = {"read_begin": q[None], "read_end": q[None], "read_valid": live[None],
         "read_txn": torch.zeros((1, q.shape[0]), dtype=torch.int32),
         "write_begin": q[None], "write_end": q[None],
         "write_valid": live[None],
         "txn_valid": torch.ones((1, 4), dtype=torch.bool)}
    SH.clip_batch(g, keys[[0, 20]], keys[[20, 63]])
    v = torch.zeros((2, 1, 4), dtype=torch.int32)
    f = torch.zeros((2, 1), dtype=torch.bool)
    SH.combine(v, v, f[..., None], f, f[:, 0], g["txn_valid"])
    G.ss_range(vals, lo, lo + 3, 4, op="max")
    G.ss_apply(64, lo, lo + 2, lo, lo, lo + 3, 4)
    K.sort_ranks(keys, live.repeat(3)[:64])
    H.merge_writes(hist, keys[:8], 50, 0)
    R.query4(R.build4(vals, op="min"), lo, lo + 9, op="min")
    S.min_cover4(64, lo, lo + 5, lo)
    assert kernels.counts() == {name: 0 for name in kernels.KERNELS}


def test_every_kernel_has_its_source():
    for info in kernels.KERNELS.values():
        src = ROOT / info.source
        assert src.is_file(), info.source
        file, line = info.replaces.split(":")
        assert (ROOT / file).is_file() and int(line) > 0
    for name in kernels.SOURCES:
        text = (kernels.CSRC / f"{name}.cu").read_text()
        assert "Replaces" in text and "ops/" in text
        assert "Bound on this card" in text
