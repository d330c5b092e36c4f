"""Useful model FLOPs over the traced window, share of the bf16 peak."""

from portbench.lib.readers import mfu_pct as read  # noqa: F401
