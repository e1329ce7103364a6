"""Kernel layer: hand-written CUDA kernels (``csrc/``), each beside its plain
torch version, and the plain-torch image ops of the front end (``image``,
``nms``). Nothing here builds or loads a kernel at import."""
