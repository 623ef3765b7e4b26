"""utils of the PyTorch port (mirrors ripcurrents_tpu/utils)."""
