"""Training of the PyTorch port: AdamW, checkpoints and the loop."""
