"""Data pipeline of the PyTorch port (a copy of ``repro.data``)."""
