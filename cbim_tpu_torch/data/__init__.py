"""Host data I/O of the port (NIfTI)."""
