"""Filter framework: uniform ``filter(pc) -> pc`` stages and a string factory.

The port of cwipc_util_tpu/filters/ (reference: python/cwipc/filters/
__init__.py:19-48).  A filter is named on the command line as ``name``,
``name(args...)``, or the path of a ``.py`` file declaring a
``CustomFilter`` class.  Argument strings are parsed with
``ast.literal_eval``, not ``eval``: the same literals, no code runs.
Every filter's result stays on its input's device.
"""

from __future__ import annotations

import ast
import importlib.util
import sys
from typing import cast

from .abstract import BaseFilter, cwipc_abstract_filter
from . import (
    analyze,
    colorize,
    crop,
    direction,
    noise,
    passthrough,
    randomize_floor,
    remove_outliers,
    simulatecams,
    transform,
    transform44,
    voxelize,
)

all_filters = [
    passthrough,
    analyze,
    voxelize,
    transform,
    transform44,
    crop,
    remove_outliers,
    colorize,
    noise,
    simulatecams,
    direction,
    randomize_floor,
]

_by_name = {mod.CustomFilter.filtername: mod for mod in all_filters}


def help() -> None:
    print(
        "A builtin filter can be specified by name (for example passthrough)"
        " or as name with arguments (for example voxelize(0.01)).",
        file=sys.stderr,
    )
    print(
        "A custom filter is specified by its Python filename (ending with .py)"
        " declaring a CustomFilter class.",
        file=sys.stderr,
    )
    print("\nThe following builtin filters are available:", file=sys.stderr)
    for mod in all_filters:
        print(mod.CustomFilter.__doc__)


def factory(filterdesc: str) -> cwipc_abstract_filter:
    """Create a filter from a description string.

    ``name``        -> filter without arguments
    ``name(args)``  -> arguments parsed as Python literals
    ``path.py``     -> loads the file and instantiates its CustomFilter
    """
    if filterdesc.lower().endswith(".py"):
        spec = importlib.util.spec_from_file_location("cwipc_custom_filter", filterdesc)
        assert spec and spec.loader
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return cast(cwipc_abstract_filter, module.CustomFilter())
    if filterdesc.endswith(")"):
        openpos = filterdesc.find("(")
        if openpos < 0:
            raise ValueError(f"Malformed filter description: {filterdesc!r}")
        filtername = filterdesc[:openpos]
        filterargs = ast.literal_eval(filterdesc[openpos:])
        if not isinstance(filterargs, tuple):
            filterargs = (filterargs,)
    else:
        filtername = filterdesc
        filterargs = ()
    # module names resolve too
    mod = _by_name.get(filtername) or globals().get(filtername)
    if mod is None or not hasattr(mod, "CustomFilter"):
        raise ValueError(f"Unknown filter: {filtername!r}")
    return cast(cwipc_abstract_filter, mod.CustomFilter(*filterargs))


__all__ = ["BaseFilter", "all_filters", "cwipc_abstract_filter", "factory", "help"]
