"""Kernel launches per request in the traced slice."""

from portbench.lib.readers import launches_per_request as read  # noqa: F401
