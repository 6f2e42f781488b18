"""Where a configuration's system is found.  Its ``system`` names the
spec class, its factory and the builder, by the same names in the
program's ``akbx_torch.systems`` and in the configuration's plain
reference: the modules of ``portbench/reference/`` that it names under
``reference`` (default ``systems``: those names and ``AlignParams``) and
``reference_trace`` (default ``trace``: ``TRACE``)."""

from __future__ import annotations

import importlib

# what the kinds call of a configuration's reference trace module
TRACE = ("run", "bench_loss", "demeaned_opl", "detector_points")


def find(module, dotted: str):
    """``module``'s attribute ``dotted`` (``Spec.factory`` walks into the
    class); ``AttributeError`` naming the module and the name where it
    lacks it."""
    obj = module
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            raise AttributeError(f"{module.__name__} has no {dotted}")
    return obj


def system_names(system: dict) -> list:
    """The names that ``system`` looks up in a systems module."""
    names = [system["spec"], system["builder"], "AlignParams"]
    if system.get("factory"):
        names.append(system["spec"] + "." + system["factory"])
    return names


def reference_modules(system: dict) -> tuple:
    """(systems, trace): the modules of ``portbench/reference/`` that
    ``system`` names.  ``ValueError`` for a name that is not a bare
    identifier or names no module there."""
    out = []
    for key, default in (("reference", "systems"),
                         ("reference_trace", "trace")):
        name = system.get(key, default)
        if not (isinstance(name, str) and name.isidentifier()):
            raise ValueError(f"{key} {name!r} is not the bare name of a "
                             "module of portbench/reference/")
        full = "portbench.reference." + name
        try:
            out.append(importlib.import_module(full))
        except ModuleNotFoundError as e:
            if e.name != full:
                raise
            raise ValueError(f"{key} {name!r}: portbench/reference/ has no "
                             f"module {name}") from None
    return tuple(out)


def unresolved(config: dict) -> list:
    """What the program's ``akbx_torch.systems``, the reference's systems
    module and its trace module lack of the names ``config`` needs: one
    line for each, naming the module and the name; empty where every name
    resolves."""
    from akbx_torch import systems as program

    system = config["system"]
    try:
        ref, ref_trace = reference_modules(system)
    except ValueError as e:
        return [str(e)]
    out = []
    for module, names in ((program, system_names(system)),
                          (ref, system_names(system)), (ref_trace, TRACE)):
        for name in names:
            try:
                find(module, name)
            except AttributeError as e:
                out.append(str(e))
    return out
