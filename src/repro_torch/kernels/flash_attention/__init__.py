from . import kernel, ops, persistent, ref  # noqa: F401
