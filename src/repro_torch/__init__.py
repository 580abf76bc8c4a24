"""PyTorch/CUDA port of the BWQ serving path.

A second package beside the JAX reference (``repro``): the same module
layout (``configs``, ``core``, ``kernels``, ``models``, ``serve``) and
names, written in PyTorch.  Each of the reference's four TPU kernels is
hand-written CUDA C++ for Hopper (``kernels/csrc``), built with ``nvcc`` at
first use; each sits beside its plain PyTorch version, which the wrapper
takes only for tensors that lie on the CPU.

Entry points (``ServeEngine``, ``ModelAPI.init``, ``to_serving_params``)
run on the CUDA device unless the caller passes ``device="cpu"``; without
a card they raise instead of falling back.
"""
