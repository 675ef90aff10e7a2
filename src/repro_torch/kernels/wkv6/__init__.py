"""RWKV6 WKV recurrence: CUDA kernel (``wkv6.py``), plain version
(``ref.py``) and the model-facing entry (``ops.py``)."""
