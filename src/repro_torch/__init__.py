"""SmartSplit on PyTorch and CUDA: the port of the JAX package ``repro``.

The same planner, split runtime and serving entry point, with the TPU
kernels replaced by hand-written CUDA kernels for Hopper (``kernels``).
Tensors on a CUDA device go through the kernels; tensors on the CPU go
through their plain PyTorch versions.  Nothing here imports JAX or the
``repro`` package."""
