"""The sweep cells' kernel routes over their least time, %. (`readers.kernel_roofline`)"""
from portbench.readers import kernel_roofline as read  # noqa: F401
