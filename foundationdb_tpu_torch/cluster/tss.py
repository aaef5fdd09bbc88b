"""TSS: testing storage servers — mirror pairs that check reads.

Capability match for the reference's TSS feature
(fdbserver/storageserver.actor.cpp TSS paths, fdbrpc/TSSComparison.h,
design in design/tss.md): a TSS is paired with one storage server,
receives the SAME mutation stream (here: it pulls the same tag from
the tag-partitioned log, so it converges on identical content by
construction), and the client DUPLICATES a sample of reads to it —
comparing results out of the request path. A mismatch is a detected
storage-engine divergence: SevError trace + counter + CODE_PROBE; the
TSS answer is never served to the application, and a dead/slow TSS
never delays a client read (the comparison is fire-and-forget).

The port's own copy of foundationdb_tpu.cluster.tss.
"""

from __future__ import annotations

from foundationdb_tpu_torch.utils.probes import code_probe, declare
from foundationdb_tpu_torch.utils.trace import SEV_ERROR, TraceEvent

declare("tss.mismatch")

#: every Nth eligible read is duplicated to the TSS pair (the
#: reference's TSS_SAMPLE class of knobs; deterministic counter here —
#: the sim lanes need reproducibility, not randomness)
TSS_SAMPLE_EVERY = 4


class TssComparator:
    """Client-side sampling + comparison state (TSSComparison.h)."""

    def __init__(self, sched, cluster):
        self.sched = sched
        self.cluster = cluster
        self._counter = 0
        self.samples = 0
        self.mismatches = 0

    def maybe_sample(self, server: int, key: bytes, version: int,
                     result) -> None:
        """Fire-and-forget duplicate of a successful get to the TSS
        paired with `server` (if any). Never raises; never blocks the
        caller's read."""
        tss = getattr(self.cluster, "client_tss", {}).get(server)
        if tss is None:
            return
        self._counter += 1
        if self._counter % TSS_SAMPLE_EVERY:
            return
        self.samples += 1

        async def compare():
            try:
                mirror = await tss.get_value(key, version)
            except Exception:
                # TSS death/slowness is a TSS problem, not a client one
                return
            if mirror != result:
                self.mismatches += 1
                code_probe(True, "tss.mismatch")
                TraceEvent("TSSMismatch", severity=SEV_ERROR).detail(
                    "Key", key
                ).detail("Version", version).detail(
                    "SSValue", result
                ).detail("TSSValue", mirror).detail(
                    "Server", server
                ).log()

        # fire-and-forget by contract (docstring): compare() contains its
        # own errors — a dead TSS must never fail the client's read
        self.sched.spawn(compare(), name=f"tss-compare-{server}")  # flowcheck: ignore[actor.fire-and-forget]
