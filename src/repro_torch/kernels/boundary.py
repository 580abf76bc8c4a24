"""The kernel boundary as a recorder sees it.

While a recorder is active (the serving-graph lint's op recorder,
``analysis.graph_lint``, pushes itself on :data:`RECORDERS`), each kernel
wrapper call appears to it as ONE opaque op named after the kernel: the
recorder runs the wrapper with its own op recording paused, so neither
the plain version's ops (a CPU tensor) nor the launch's bookkeeping ops (a
CUDA tensor) are seen, then records the call with the wrapper's tensor
operands and its output.  That is the reference's taint sink at
``pallas_call``: dequantization inside a kernel is the design.  The plain
versions that the ``ref`` backends call directly stay visible.

With no recorder active a wrapper call pays one truth test of this list.
"""
from __future__ import annotations

# Stack of active recorders; each has ``kernel_call(name, fn, args,
# kwargs)``, which runs ``fn(*args, **kwargs)`` unrecorded (the stack
# emptied meanwhile, so the nested call takes the plain branch) and
# records one op ``name``.
RECORDERS: list = []
