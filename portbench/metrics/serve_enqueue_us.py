"""Host time of a served call before its read-back, us. (`readers.serve_enqueue_us`)"""
from portbench.readers import serve_enqueue_us as read  # noqa: F401
