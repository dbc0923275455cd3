"""Small host-side utilities of the PyTorch port."""
