"""The serve cell's share of the bf16 dense peak, %. (`readers.step_mfu_serve`)"""
from portbench.readers import step_mfu_serve as read  # noqa: F401
