"""Faults planted in the program underneath a run, to see ``correct``
come out false.  The faults a system can have are in its
``small/<system>.py``, as ``FAULTS``: each name mapped to a function that
plants the fault in this process and returns the function that undoes
it.  This module finds them by the cell, and gives them ``Patches``."""
from __future__ import annotations


class Patches:
    """Attributes set in place, each put back by ``restore()``, the last
    first."""

    def __init__(self):
        self._undo = []

    def set(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def restore(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)


def apply(cell: str, name: str):
    """Plant the fault ``name`` of the cell's system; returns its
    restore."""
    import pb_small
    faults = pb_small.settings(cell).FAULTS
    if name not in faults:
        raise ValueError(f"unknown fault {name!r} of {cell} "
                         f"(have {sorted(faults)})")
    return faults[name]()
