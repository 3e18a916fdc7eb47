"""Layer library of the port (convolutional and transformer blocks)."""
