"""Traffic generators, one module per traffic `kind`."""
