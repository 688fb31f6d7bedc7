"""The matrix-free cell's share of the tier's dense peak, %. (`readers_matfree.step_mfu`)"""
from portbench.readers_matfree import step_mfu as read  # noqa: F401
