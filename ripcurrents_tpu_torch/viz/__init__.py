"""viz of the PyTorch port (mirrors ripcurrents_tpu/viz)."""
