"""The program's entries that a cell's window drives, one module each,
found by the name a configuration or a traffic mix gives. Each module has
an ``Entry(model, cfg, device, mesh)`` with ``step(x)``, the entry as a
user calls it, and ``traced_step(x, mark)``, the public functions it
composes called in turn with ``mark(stage)`` after each, returning the same
answers bit for bit."""

import importlib


def load(name: str):
    """The ``Entry`` class of ``entries/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}").Entry
