"""The matrix-free cell's Krylov solver device time per swipe, ms. (`readers_matfree.krylov_ms_per_swipe`)"""
from portbench.readers_matfree import krylov_ms_per_swipe as read  # noqa: F401
