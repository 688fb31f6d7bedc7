"""The sweep cells' share of the tier's dense peak, %. (`readers.step_mfu`)"""
from portbench.readers import step_mfu as read  # noqa: F401
