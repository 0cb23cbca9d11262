"""PyTorch/CUDA port of the streamed geospatial pipeline framework.

Beside the JAX reference package ``repro``, with the same layout
(``core``, ``raster``, ``filters``, ``kernels``, ``pipelines``).  It imports
neither JAX nor ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the kernels of the main path are hand-written CUDA
C++ for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.
"""
