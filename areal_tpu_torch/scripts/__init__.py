"""Scripts of the PyTorch port that run as ``python -m
areal_tpu_torch.scripts.<name>``."""
