"""Measurement scripts of the PyTorch port, run as ``python -m f5tts_tpu_torch.scripts.<name>``."""
