"""Part of foundationdb_tpu_torch (see the package docstring)."""
