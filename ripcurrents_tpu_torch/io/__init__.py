"""Host video I/O of the PyTorch port (mirrors ripcurrents_tpu/io)."""
