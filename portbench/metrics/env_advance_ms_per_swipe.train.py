"""The sweep cells' env advances per swipe, ms. (`readers.env_advance_ms_per_swipe`)"""
from portbench.readers import env_advance_ms_per_swipe as read  # noqa: F401
