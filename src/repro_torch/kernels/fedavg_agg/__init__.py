"""Streaming weighted parameter sums: the FedAvg round barrier and the
FedAsync batched mix. CUDA kernels (``fedavg_agg.py``), plain versions
(``ref.py``) and the tree layer with the exact int64 coefficient fold
(``ops.py``)."""
