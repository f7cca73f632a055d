"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``conv2d`` -- fused conv(+bias)(+relu/relu6)(+maxpool), dense,
  grouped and depthwise (``csrc/conv2d.cu``);
* ``quant`` -- the int8 boundary codec (``csrc/quant.cu``);
* ``flash_attention``, ``rwkv6_wkv``, ``mamba2_ssd`` -- the sequence
  mixers (``csrc/{flash_attention,rwkv6_wkv,mamba2_ssd}.cu``);
* ``ops`` -- the public surface, as ``repro.kernels.ops``: block checks,
  padding, and every kernel above;
* ``ref`` -- the plain versions, which the wrappers run for CPU tensors;
* ``launches`` -- the per-kernel launch counters;
* ``_build`` -- ``nvcc`` + ``ctypes``, at first use.

Submodules are imported by name; nothing here builds or loads a kernel."""
