"""Measurement tools of the port (`python -m dipole_tpu_torch.tools.<name>`)."""
