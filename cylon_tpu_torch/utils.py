"""Small shared helpers (the port's copy of ``cylon_tpu/utils/__init__.py``
helpers it needs; the port never imports the JAX package)."""


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(n, minimum)."""
    return max(int(minimum), 1 << max(int(n) - 1, 0).bit_length())
