"""Fleet-side kernels of the PyTorch port, written by hand for Hopper."""
