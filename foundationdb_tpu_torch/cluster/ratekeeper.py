"""The Ratekeeper's shared constant (the port's own copy of
`FAILSAFE_TAU` from foundationdb_tpu.cluster.ratekeeper).

The wire ProxyPipeline's rate fetcher decays its budget toward the
fail-safe floor with this e-folding time when the ratekeeper stops
answering, and a GetRateInfo payload may override it. The admission law
(`AdmissionController`) and the wire `RatekeeperRole` wait for the
sim-cluster slice.
"""

from __future__ import annotations

#: e-folding time (seconds) of the fail-safe budget decay: one constant
#: for every decay path (the law's own stale-feed decay, a GRV proxy's
#: dead-ratekeeper decay, the wire ProxyPipeline's fetch-failure decay);
#: the wire consumer receives it in the GetRateInfo payload, so tuning
#: the law tunes every consumer
FAILSAFE_TAU = 0.5
