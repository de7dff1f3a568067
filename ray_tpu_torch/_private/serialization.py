"""Serialization: stdlib pickle protocol 5 with out-of-band buffers.

The port's copy of ``ray_tpu/_private/serialization.py``, on the standard
library instead of cloudpickle. The wire format is the same::

    [u32 nbuf] [u64 meta_len] [meta pickle bytes] [u64 len, buf bytes]*

Large contiguous buffers (numpy arrays, torch tensors, bytes; 4096 bytes
or more) are carried out-of-band so the object-store write path can splice
them without copying through pickle, and the read path reconstructs them
as zero-copy views onto the shared-memory mapping. For plain data (numpy
arrays, bytes, containers) the chunks are byte for byte those of the JAX
package.

What pickle cannot name, ``_Pickler`` pickles **by value**: a function or
class defined in ``__main__`` or inside a function, a lambda, a closure.
A function travels as its code (``marshal``), the globals its code reaches
(read from its ``LOAD_GLOBAL`` / ``STORE_GLOBAL`` names, nested code
included), its closure cells and its defaults; a class as a skeleton
(metaclass, name, bases) and then its namespace. The skeleton is rebuilt
before its state is read, so a function that calls itself, or a method
that names its own class, refers back to the one object. Everything that
can be imported by name still goes by reference.

Torch tensors: a dense CPU tensor of any dtype (bf16 and fp8 included)
goes out-of-band as its raw bytes with its dtype and shape (a strided one
is made contiguous first); a CUDA tensor is carried as its host bytes and
comes back on the CPU (the port's device is always explicit). A tensor or
array returned by ``get`` aliases the store's read-only mapping: copy it
(``.clone()``, ``.copy()``) before writing to it.

The cross-language (XLANG, msgpack) envelope of the JAX package is not
carried over.
"""
from __future__ import annotations

import builtins
import dis
import importlib
import io
import marshal
import pickle
import struct
import sys
import types
import warnings
from typing import Any

# Buffers smaller than this are kept in-band; the indirection isn't worth it.
_OOB_THRESHOLD = 4096

_GLOBAL_OPS = {dis.opmap[n] for n in ("LOAD_GLOBAL", "STORE_GLOBAL",
                                      "DELETE_GLOBAL")}
_code_globals_cache: dict = {}


def _code_globals(code: types.CodeType) -> dict:
    """The global names ``code`` (and every code object nested in it)
    loads, stores or deletes, in first-use order."""
    names = _code_globals_cache.get(code)
    if names is None:
        names = {}
        for ins in dis.get_instructions(code):
            if ins.opcode in _GLOBAL_OPS:
                names[ins.argval] = None
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                names.update(_code_globals(const))
        _code_globals_cache[code] = names
    return names


def _importable(obj) -> bool:
    """True when ``obj`` is what its module and qualified name lead to, so
    a reader can import it by reference."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None) or getattr(
        obj, "__name__", None)
    if not module or module == "__main__" or not qualname:
        return False
    if "<locals>" in qualname or "<lambda>" in qualname:
        return False
    found = sys.modules.get(module)
    if found is None:
        return False
    for part in qualname.split("."):
        found = getattr(found, part, None)
        if found is None:
            return False
    return found is obj


# ---- rebuilders (referenced by name from the pickle) ----

def _make_function(code_bytes, base_globals, name, ncells):
    code = marshal.loads(code_bytes)
    closure = tuple(types.CellType() for _ in range(ncells)) or None
    return types.FunctionType(code, base_globals, name, None, closure)


def _set_function_state(func, state):
    func.__globals__.update(state["globals"])
    func.__globals__.setdefault("__builtins__", builtins)
    for i, value in state["cells"]:
        func.__closure__[i].cell_contents = value
    func.__defaults__ = state["defaults"]
    func.__kwdefaults__ = state["kwdefaults"]
    func.__qualname__ = state["qualname"]
    func.__module__ = state["module"]
    func.__doc__ = state["doc"]
    func.__dict__.update(state["dict"])
    return func


def _make_class(meta, name, bases, namespace):
    return meta(name, bases, namespace)


def _set_class_state(cls, state):
    for key, value in state.items():
        setattr(cls, key, value)
    return cls


def _import(name):
    return importlib.import_module(name)


def _rebuild_tensor(buf, dtype_name: str, shape: tuple):
    import torch

    dtype = getattr(torch, dtype_name)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        # the store's mapping is read-only: the tensor aliases it (see the
        # module docstring)
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(buf, dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def _reduce_tensor(torch, t):
    if t.layout is not torch.strided or t.is_quantized:
        return NotImplemented
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    dtype_name = str(t.dtype).removeprefix("torch.")
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw), dtype_name,
                             tuple(t.shape))


class _Pickler(pickle.Pickler):
    """Protocol-5 pickler that also carries what cannot be imported by
    name (see the module docstring)."""

    def __init__(self, file, buffer_callback=None):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        # id(original globals dict) -> the dict the rebuilt functions share
        self._globals_ref: dict[int, dict] = {}

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            return NotImplemented if _importable(obj) else self._function(obj)
        if isinstance(obj, type):
            return NotImplemented if _importable(obj) else self._class(obj)
        if t is types.ModuleType:
            return _import, (obj.__name__,)
        if t in (classmethod, staticmethod):
            return t, (obj.__func__,)
        if t is property:
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        torch = sys.modules.get("torch")
        if torch is not None and t is torch.Tensor:
            return _reduce_tensor(torch, obj)
        return NotImplemented

    def _function(self, func):
        code = func.__code__
        g = func.__globals__
        base = self._globals_ref.get(id(g))
        if base is None:
            base = self._globals_ref[id(g)] = {"__name__": g.get("__name__")}
        state = {
            "globals": {n: g[n] for n in _code_globals(code) if n in g},
            "cells": [],
            "defaults": func.__defaults__,
            "kwdefaults": func.__kwdefaults__,
            "qualname": func.__qualname__,
            "module": func.__module__,
            "doc": func.__doc__,
            "dict": dict(func.__dict__),
        }
        for i, cell in enumerate(func.__closure__ or ()):
            try:
                state["cells"].append((i, cell.cell_contents))
            except ValueError:  # an empty cell stays empty
                pass
        args = (marshal.dumps(code), base, func.__name__,
                len(func.__closure__ or ()))
        return _make_function, args, state, None, None, _set_function_state

    def _class(self, cls):
        ns = {"__module__": cls.__module__, "__qualname__": cls.__qualname__,
              "__doc__": cls.__doc__}
        slots = cls.__dict__.get("__slots__")
        skip = {"__dict__", "__weakref__", "__module__", "__qualname__",
                "__doc__", "__slots__", "_abc_impl"}
        if slots is not None:
            ns["__slots__"] = slots
            skip.update([slots] if isinstance(slots, str) else slots)
        state = {k: v for k, v in cls.__dict__.items() if k not in skip}
        args = (type(cls), cls.__name__, cls.__bases__, ns)
        return _make_class, args, state, None, None, _set_class_state


def _dumps(value: Any, buffer_callback=None) -> bytes:
    out = io.BytesIO()
    _Pickler(out, buffer_callback).dump(value)
    return out.getvalue()


def dumps_by_value(value: Any) -> bytes:
    """One in-band pickle of ``value`` (functions and classes included)."""
    return _dumps(value)


def serialize(value: Any) -> list[bytes | memoryview]:
    """Serialize to a list of chunks: header + meta + raw buffers.

    Returns a chunk list rather than one bytes object so callers can write
    the chunks straight into a shared-memory allocation without an extra
    concatenation copy.
    """
    buffers: list[pickle.PickleBuffer] = []

    def buffer_callback(pb: pickle.PickleBuffer) -> bool:
        with pb.raw() as m:
            if m.nbytes < _OOB_THRESHOLD:
                return True  # keep small buffers in-band
        buffers.append(pb)
        return False

    meta = _dumps(value, buffer_callback)
    chunks: list[bytes | memoryview] = []
    raw_views = []
    for pb in buffers:
        m = pb.raw()
        raw_views.append(m if m.contiguous else memoryview(bytes(m)))
    header = struct.pack("<IQ", len(raw_views), len(meta))
    chunks.append(header)
    chunks.append(meta)
    for m in raw_views:
        chunks.append(struct.pack("<Q", m.nbytes))
        chunks.append(m)
    return chunks


def serialized_size(chunks: list[bytes | memoryview]) -> int:
    return sum(c.nbytes if isinstance(c, memoryview) else len(c) for c in chunks)


def write_chunks(chunks: list[bytes | memoryview], dest: memoryview) -> None:
    offset = 0
    for c in chunks:
        n = c.nbytes if isinstance(c, memoryview) else len(c)
        dest[offset : offset + n] = c
        offset += n


def dumps(value: Any) -> bytes:
    out = io.BytesIO()
    for c in serialize(value):
        out.write(c)
    return out.getvalue()


def deserialize(data: bytes | memoryview) -> Any:
    """Deserialize from one contiguous buffer, zero-copy for array payloads.

    When ``data`` is a memoryview over shared memory, reconstructed numpy
    arrays and torch tensors alias that memory — the caller must keep the
    mapping alive for the lifetime of the returned object (the ObjectRef
    pinning does this) and must not write to them.
    """
    view = memoryview(data)
    nbuf, meta_len = struct.unpack_from("<IQ", view, 0)
    offset = 12
    meta = view[offset : offset + meta_len]
    offset += meta_len
    out_of_band = []
    for _ in range(nbuf):
        (blen,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        out_of_band.append(view[offset : offset + blen])
        offset += blen
    return pickle.loads(meta, buffers=out_of_band)


loads = deserialize
