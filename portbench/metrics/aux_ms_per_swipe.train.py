"""The sweep cells' library and elementwise device time per swipe, ms. (`readers.aux_ms_per_swipe`)"""
from portbench.readers import aux_ms_per_swipe as read  # noqa: F401
