"""Checkpoints of the port (the serving half of `skypilot_tpu/data`)."""
