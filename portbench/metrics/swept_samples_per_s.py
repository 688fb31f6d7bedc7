"""Sample-swipes of the sweep cells' epochs completed in the window over its length. (`readers.rate`)"""
from portbench.readers import rate as read  # noqa: F401
