"""The ctypes bindings of the port's CUDA kernels against their C entry
points, on the CPU: every `_build.bind` call in `if_defense_tpu_torch/ops/`
names one type for each parameter of the C function it binds, the trailing
stream included, pointers as pointers. ctypes passes an argument past the
types it was given as a 32-bit C int, so a binding that leaves out the
stream would cut its 64-bit handle; `_build.launch` refuses such a binding
before it calls it.
"""

import ast
import ctypes
import importlib
import os
import re

import pytest
import torch

from if_defense_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = os.path.join(ROOT, "if_defense_tpu_torch", "ops")
CSRC = os.path.join(ROOT, "if_defense_tpu_torch", "csrc")


def c_entries() -> dict:
    """{(library, function): [parameter declarations]} of every
    `int ifdef_*(...)` entry point in `csrc/*.cu`."""
    out = {}
    for f in sorted(os.listdir(CSRC)):
        if not f.endswith(".cu"):
            continue
        text = open(os.path.join(CSRC, f)).read()
        for m in re.finditer(r"\bint\s+(ifdef_\w+)\s*\(([^)]*)\)\s*\{", text):
            out[(f[:-3], m.group(1))] = [
                p.strip() for p in m.group(2).split(",") if p.strip()]
    return out


def bindings() -> list:
    """(module, library, function, argument types) of every
    `_build.bind(...)` call in the port's `ops/` modules, the types
    evaluated in their module."""
    out = []
    for f in sorted(os.listdir(OPS)):
        if not f.endswith(".py"):
            continue
        path = os.path.join(OPS, f)
        tree = ast.parse(open(path).read(), path)
        mod = None
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "bind"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                mod = mod or importlib.import_module(
                    f"if_defense_tpu_torch.ops.{f[:-3]}")
                lib, name = (a.value for a in node.args[:2])
                types = eval(compile(ast.Expression(node.args[2]), path,
                                     "eval"), vars(mod))
                out.append((f[:-3], lib, name, list(types)))
    return out


BINDINGS = bindings()


def test_every_launching_entry_point_is_bound():
    """Each binding names a C entry point, and each entry point that takes
    a stream has a binding."""
    bound = {(lib, name) for _, lib, name, _ in BINDINGS}
    entries = c_entries()
    assert bound <= set(entries), bound - set(entries)
    launching = {k for k, p in entries.items() if p and p[-1].endswith(
        "stream")}
    assert launching <= bound, launching - bound


@pytest.mark.parametrize("binding", BINDINGS,
                         ids=[f"{m}.{n}" for m, _, n, _ in BINDINGS])
def test_binding_matches_c_signature(binding):
    _, lib, name, types = binding
    params = c_entries()[(lib, name)]
    assert len(types) == len(params), (name, types, params)
    if params:                         # the entry points that launch
        assert params[-1] == "void* stream", params[-1]
    for t, p in zip(types, params):
        if "*" in p:
            assert t is ctypes.c_void_p or issubclass(t, ctypes._Pointer), p
            if p.count("*") > 1:
                assert issubclass(t, ctypes._Pointer), p
        elif p.split()[0] == "int":
            assert t is ctypes.c_int, p
        else:
            assert p.split()[0] == "float" and t is ctypes.c_float, p


def test_launch_refuses_a_binding_without_the_stream():
    """A binding one type short (the stream left out) raises before it is
    called or counted."""
    calls, launches = [], {"k": 0}

    def fn(*args):
        calls.append(args)
        return 0

    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    with pytest.raises(TypeError, match="the stream"):
        _build.launch("x", "a kernel", fn, (0, 1), torch.zeros(1), launches,
                      "k")
    assert calls == [] and launches == {"k": 0}
