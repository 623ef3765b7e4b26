"""analysis of the PyTorch port (mirrors ripcurrents_tpu/analysis)."""
