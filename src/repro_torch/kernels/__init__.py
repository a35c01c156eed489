"""Hand-written CUDA kernels of m4's and flowSim's hot paths and their
plain versions.

    fused_gru/   the fused GRU cell pair      (csrc/fused_gru.cu)
    bipartite/   the GraphSAGE round          (csrc/bipartite.cu)
    waterfill/   flowSim's water-filling      (csrc/waterfill.cu): one
                 event's rounds in one launch, and the masked row-min
    dispatch.py  CPU tensor -> plain version, CUDA tensor -> kernel
    build.py     nvcc at first use, loaded with ctypes
"""
