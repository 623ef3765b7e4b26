"""dynamics of the PyTorch port (mirrors ripcurrents_tpu/dynamics)."""
