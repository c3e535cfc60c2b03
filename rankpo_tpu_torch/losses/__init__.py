"""losses layer of the PyTorch port (see the matching rankpo_tpu.losses)."""
