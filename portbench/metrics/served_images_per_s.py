"""Images whose predictions reached the host in the window over its length. (`readers.rate`)"""
from portbench.readers import rate as read  # noqa: F401
