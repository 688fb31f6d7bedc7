"""The sweep cells' solve device time per swipe, ms. (`readers.solve_ms_per_swipe`)"""
from portbench.readers import solve_ms_per_swipe as read  # noqa: F401
