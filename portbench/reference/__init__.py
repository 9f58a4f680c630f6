"""The benchmark's plain reference: a frozen copy of ddsp_piano_torch's
plain PyTorch path for maestro_v2 and dafx22 (models, processors, ops,
layers and the plain versions of its kernels), taken at the commit that
added the benchmark.

It imports nothing of ddsp_piano_torch or of the JAX package: a later
change to the port leaves it as it is, so it stays the yardstick of
``correct``. Only the kernel modules differ from the port's files: they
keep the plain versions and their autograd Functions and drop every CUDA
launch. ``allocator`` is a copy of the port's numpy voice allocator.
"""
