"""The layers a configuration runs, as the benchmark models them: one
module a family, ``kvbench/families/<family>.py``, picked by the
configuration file's ``"family"`` key (``dense`` where the file has
none).

A family module provides

  leaves(model, mlp)        — (path, shape, scale) or (path, shape, scale,
                              dtype) of every leaf of one parameter set,
                              in the program's layout; a leaf without a
                              dtype is drawn in the served one
                              (``kvbench.weights.make_params``);
  Reference(model, mlp, params, mode)
                            — the plain reference, ``mode`` "fp32" or
                              "fp8" (the control), with ``sender_kv``,
                              ``receiver``, ``m`` and ``dev`` as
                              ``kvbench.reference`` uses them;
  window_flops(model, mlp, items, sel), k1_bytes(model, items, sel)
                            — the needed operations and K1 bytes that
                              ``mfu_pct`` and ``k1_roofline_pct`` divide by;

and optionally ``EXTRA_NUMBERS`` with ``extra_numbers(view)``: numbers
the check compares beside its four (``kvbench.check``), each held to a
limit of the cell's workloads file. A family imports nothing of the
program.
"""
from __future__ import annotations

import importlib
import re
from types import ModuleType
from typing import Dict

DEFAULT = "dense"
REQUIRED = ("leaves", "Reference", "window_flops", "k1_bytes")
_NAME = re.compile(r"[a-z][a-z0-9_]*\Z")


def of(config: Dict) -> ModuleType:
    """The family module of a configuration file's contents."""
    name = config.get("family", DEFAULT)
    who = config.get("name", "a configuration")
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{who}: family {name!r} is not a module name")
    full = f"{__name__}.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"{who}: unknown family {name!r} (no "
                         f"kvbench/families/{name}.py)") from None
    missing = [a for a in REQUIRED if not hasattr(mod, a)]
    if getattr(mod, "EXTRA_NUMBERS", ()) and not hasattr(mod,
                                                          "extra_numbers"):
        missing.append("extra_numbers")
    if missing:
        raise ValueError(f"{who}: family {name!r} lacks {missing}")
    return mod
