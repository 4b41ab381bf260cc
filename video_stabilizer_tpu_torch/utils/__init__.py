"""Host-side helpers of the PyTorch port."""
