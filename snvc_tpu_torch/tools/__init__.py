"""See the package docstring of snvc_tpu_torch."""
