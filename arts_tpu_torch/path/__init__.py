from .geometry import PathGeometry, geometric_path_1d  # noqa: F401
