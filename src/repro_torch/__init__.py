"""NSHEDB on PyTorch and CUDA.

The same encrypted query engine as the `repro` package, written against
`torch` tensors, with the limb-level hot loops (negacyclic NTT, pointwise
modular mul/add/sub) as hand-written CUDA kernels for NVIDIA Hopper
(`kernels/csrc/`).  Module paths mirror `repro`'s: `core/`, `kernels/`,
`engine/`, `runtime/`.

Entry points (`LimbOps`, `BFVContext`, `BFVBackend`) take a `device`
argument that defaults to "cuda"; pass "cpu" to run the plain PyTorch
versions of the kernels instead (what the CPU tests do).
"""
