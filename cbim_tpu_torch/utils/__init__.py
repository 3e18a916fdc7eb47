"""Utilities of the port: weight import from the JAX package's params."""
