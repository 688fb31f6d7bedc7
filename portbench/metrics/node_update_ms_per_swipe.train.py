"""The sweep cells' node updates per swipe, ms. (`readers.node_update_ms_per_swipe`)"""
from portbench.readers import node_update_ms_per_swipe as read  # noqa: F401
