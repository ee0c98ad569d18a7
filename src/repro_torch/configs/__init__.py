from .registry import ALL_ARCHS, get_bundle, shapes_for  # noqa: F401
