"""Drivers: one per kind of traffic, found by the name a traffic file gives.

A driver module defines

- ``SPANS``: (module, attribute, label) of the program's functions that a
  traced run wraps in ``bench:<label>`` ranges (``harness/trace.py``);
- ``setup(ctx) -> state``: everything before the window (inputs, the
  program's set-up, the warm-up of this traffic's shapes);
- ``window(state, seconds) -> record``: the measured work, a dict with at
  least ``attempted``, ``failed`` and ``window_s``;
- ``release(state)``: drop the program's device state once the peak
  memory has been read;
- ``check(state, record) -> {name: value}``: the comparison with the
  plain reference, each number a worst case; those the workload file
  gives a limit decide ``correct`` (a number above its limit fails), the
  others are printed for the record.

``ctx`` carries ``seed``, ``config``, ``traffic``, ``workload``,
``device``, ``workdir`` and ``low_precision`` (the program's own bfloat16
path switched on, as the configuration's ``low_precision`` names it; the
tests hold that such a run fails the comparison).
"""
