"""Relational operators of the port (mirrors ``cylon_tpu/ops``)."""
