"""Matvecs the matrix-free cell's program launched per swipe. (`readers_matfree.krylov_matvecs_per_swipe`)"""
from portbench.readers_matfree import krylov_matvecs_per_swipe as read  # noqa: F401
