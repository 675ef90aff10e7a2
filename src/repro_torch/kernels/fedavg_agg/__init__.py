"""Streaming weighted parameter average (FedAvg round barrier): CUDA
kernel (``fedavg_agg.py``), plain version (``ref.py``) and the tree
layer (``ops.py``)."""
