from . import bits, boundaries, radix_sort  # noqa: F401
