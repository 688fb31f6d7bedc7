"""The serve cell's device idle share, %. (`readers.idle_share`)"""
from portbench.readers import idle_share as read  # noqa: F401
