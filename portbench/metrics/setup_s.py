"""Seconds from the process's start to the window's. (`readers.setup`)"""
from portbench.readers import setup as read  # noqa: F401
