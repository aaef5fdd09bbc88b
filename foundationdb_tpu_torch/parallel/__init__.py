"""Multi-resolver sharding of the conflict check (parallel/sharding.py)."""
