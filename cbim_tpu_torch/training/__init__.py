"""Training runtime of the port (counterpart of ``cbim_tpu/training``)."""
