"""The coloring library's data consumer (``coloring_sched``) and the LM's
synthetic, step-indexed data stream (``pipeline``), in the PyTorch port."""
