"""Plain PyTorch references of the models the port serves: fp32, no
cache, no batching, nothing of the port's kernels or layers."""
