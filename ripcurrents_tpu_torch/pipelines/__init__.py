"""pipelines of the PyTorch port (mirrors ripcurrents_tpu/pipelines)."""
