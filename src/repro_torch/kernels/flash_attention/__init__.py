"""Causal / sliding-window GQA attention forward: CUDA kernel
(``flash_attention.py``), plain version (``ref.py``) and the model-facing
entry (``ops.py``)."""
