"""flow of the PyTorch port (mirrors ripcurrents_tpu/flow)."""
