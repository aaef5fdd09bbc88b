"""The port's drills: the soak ensemble, the saturation ramp and the hotspot
gate as command-line programs (`python -m foundationdb_tpu_torch.drills.
soak`, `.saturation`, `.hotspot`). Each resolves on the card unless it is
given `--device cpu`."""
