"""parallel of the PyTorch port (mirrors ripcurrents_tpu/parallel)."""
