"""Blockwise int8 codec of the FFLY v2 delta migration payload: CUDA
kernels (``int8_codec.py``), plain versions (``ref.py``) and the
multi-leaf packing layer (``ops.py``)."""
