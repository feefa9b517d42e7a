from . import kernel, persistent  # noqa: F401
