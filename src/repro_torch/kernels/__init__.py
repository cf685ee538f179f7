"""Hand-written Hopper kernels for the hot spots.

  grouped_scatter/   the paper's technique as a kernel: conflict-group
                     segment reduction (CUDA C++, sm_90a)

Each subpackage ships kernel.py (build, ctypes binding, wrapper with a
launch count), csrc/ (the CUDA source), ops.py (the entry point) and ref.py
(the plain PyTorch version the wrapper uses for CPU tensors).
"""
