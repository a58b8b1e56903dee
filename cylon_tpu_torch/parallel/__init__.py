"""Distributed execution of the port: communicators, shuffle, dist ops
(mirrors ``cylon_tpu/parallel``)."""
