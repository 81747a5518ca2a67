"""One module per architecture; each registers its FULL and SMOKE configs."""
