"""Hand-written CUDA kernels of m4's hot path and their plain versions.

    fused_gru/   the fused GRU cell pair      (csrc/fused_gru.cu)
    bipartite/   the GraphSAGE round          (csrc/bipartite.cu)
    dispatch.py  CPU tensor -> plain version, CUDA tensor -> kernel
    build.py     nvcc at first use, loaded with ctypes
"""
