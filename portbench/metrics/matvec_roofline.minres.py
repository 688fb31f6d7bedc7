"""The matrix-free cell's matvecs' share of their roofline, %. (`readers_matfree.matvec_roofline`)"""
from portbench.readers_matfree import matvec_roofline as read  # noqa: F401
