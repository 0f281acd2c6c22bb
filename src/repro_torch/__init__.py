"""WawPart on PyTorch and CUDA: workload-aware knowledge-graph partitioning
and a batched federated BGP query engine whose scan and join kernels are
hand-written CUDA C++ for Hopper (sm_90a).

The package stands alone: it imports torch and numpy only.
"""
