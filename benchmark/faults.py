"""Faults planted in the program underneath a run, to show that the check
catches them. Each driver's `FAULTS` maps a fault's name to a function
that returns a context manager patching one function of the port for the
run (`patched`). The names:

  unchanged_state  the optimizer's step returns its state unchanged
  half_batch       half of the batch left out, the mean taken over the rest
  answer_altered   an answer altered where it is produced
  sweep_skipped    (samplers) the sweep returns its chains unchanged

`benchmark/tests/test_bench_drivers.py` runs them at a small size on the
CPU; `control.py --fault` reads them on the card at a cell's size.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name, make):
    """obj.name replaced by make(original) inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def adam_noop(orig):
    """ClippedAdam.step that counts the step and changes nothing."""
    def step(self, corr=None):
        if corr is None:
            self.corrections()
    return step


def plant(driver: str, fault: str):
    """The context manager that plants `fault` under `driver`'s entry point."""
    from benchmark import harness

    return harness.load_module("drivers", driver).FAULTS[fault]()
