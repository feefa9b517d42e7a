"""setup_s: process start until the first timed drain (s): imports, the
build or load of the cell's libraries, the inputs and two warm-up drains.
The reference's own work in set-up (a driver's ``reference_s``) is left out:
it serves the check, which every run pays after the window."""


def read(ctx):
    return ctx.set_up_s if ctx.trace is None else None
