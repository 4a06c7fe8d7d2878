"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes loader
(``build``), the wrappers beside their plain PyTorch versions (``mvau``,
``gap``, ``ref``) and the graph-node dispatch (``ops``)."""
