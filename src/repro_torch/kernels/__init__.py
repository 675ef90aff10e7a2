"""Hand-written CUDA kernels of the port (sources under ``csrc/``), each
with a plain PyTorch version beside it. ``native`` builds and loads them
at first use and counts their launches."""
