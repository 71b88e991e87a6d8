"""Drivers: the loops a traffic mix drives the program with.

A traffic file names its driver (`"driver": "apply"`); the driver reads
the rest of the file as its parameters.  Each driver is a class `Driver`:

  Driver(config, traffic, seed, devices, seconds)
  setup()           make the inputs from the seed, build the program's
                    objects, warm up every shape the window uses
  window()          the measured window, `seconds` long: returns a dict
                    with `window_s`, `attempted`, `failed`, `e2e` ({metric:
                    value}) and the facts the per-layer readers take
                    (`facts`)
  release()         drop the program's state (after the memory peak is
                    read), keeping the outputs to judge
  use_control(dtype, leaf_dtype)
                    replace the outputs to judge by a control's: the
                    reference in the program's place, computing in `dtype`
                    and keeping its leaf values in `leaf_dtype`
  check()           {name: (number, limit)}: the outputs against the
                    float64 reference
"""
import importlib


def load(name: str):
    """The `Driver` class of driver module `name`."""
    return importlib.import_module(f"benchlib.drivers.{name}").Driver
