"""Serving engines of the PyTorch port: the batched CNN split-serving
engine (``cnn_engine``, the paper's workload under load) and the bucketed
transformer decode engine (``engine``)."""
