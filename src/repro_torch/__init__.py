"""PyTorch port of the REXA VM (see README "The PyTorch port")."""
