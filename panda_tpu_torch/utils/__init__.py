from . import trace  # noqa: F401
