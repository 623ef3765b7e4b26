"""ops of the PyTorch port (mirrors ripcurrents_tpu/ops)."""
