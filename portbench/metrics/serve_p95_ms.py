"""The 95th percentile of a served batch's latency, ms. (`readers.serve_p95_ms`)"""
from portbench.readers import serve_p95_ms as read  # noqa: F401
