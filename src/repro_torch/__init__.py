"""PyTorch/CUDA port of the FedFly system (``repro``'s counterpart).

Mirrors the layout of the JAX package module for module and never
imports it: every helper the port needs lives here. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; the kernels of
the main path (the int8 migration codec and the FedAvg barrier) are
hand-written CUDA C++ for Hopper under ``kernels/csrc``.
"""
