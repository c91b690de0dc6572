from .hg import HenyeyGreenstein  # noqa: F401
