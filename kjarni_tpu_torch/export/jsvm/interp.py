"""Tree-walking evaluator for the jsvm JavaScript subset.

Value model:
  undefined        -> the UNDEFINED singleton
  null             -> Python None
  number           -> Python int/float (JS semantics: `/` is true division,
                      bit-ops go through int32; int/float compare equal)
  string           -> Python str
  object           -> JSObject (props dict + optional JSClass)
  array            -> JSArray (wraps a Python list)
  Float32Array etc -> TypedArray (memoryview over an ArrayBuffer's bytearray;
                      reads return Python floats, writes round to the element
                      dtype — exactly JS typed-array semantics)
  function/class   -> JSFunction / NativeFunction / BoundMethod / JSClass

Async is executed synchronously: `await` unwraps JSPromiseValue, fetch/
Promise.all return already-resolved JSPromiseValues. That is sufficient for
web/kjarni.js (whose only async is bundle loading) and keeps the VM tiny.

A verbatim copy of kjarni_tpu/export/jsvm/interp.py (the port imports nothing
of the JAX package); only this paragraph differs.
"""

from __future__ import annotations

import json
import math
import unicodedata
from functools import cmp_to_key
from pathlib import Path

import numpy as np
import regex as _regex

from .lexer import JSSyntaxError
from .parser import parse

_MISSING = object()


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

class JSUndefinedType:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = JSUndefinedType()
JSUndefined = UNDEFINED  # re-exported alias


class JSObject:
    __slots__ = ("props", "klass")

    def __init__(self, props=None, klass=None):
        self.props = props if props is not None else {}
        self.klass = klass

    def __repr__(self):
        name = self.klass.name if self.klass else "Object"
        return f"[{name} {{{', '.join(list(self.props)[:6])}}}]"


class JSArray:
    __slots__ = ("items",)

    def __init__(self, items=None):
        self.items = items if items is not None else []

    def __repr__(self):
        return f"JSArray({self.items!r})"


class JSFunction:
    __slots__ = ("name", "params", "body", "is_expr_body", "env", "is_arrow",
                 "is_async")

    def __init__(self, name, params, body, is_expr_body, env, is_arrow,
                 is_async):
        self.name = name
        self.params = params
        self.body = body
        self.is_expr_body = is_expr_body
        self.env = env
        self.is_arrow = is_arrow
        self.is_async = is_async

    def __repr__(self):
        return f"[Function {self.name or '(anonymous)'}]"


class NativeFunction:
    __slots__ = ("name", "fn", "props")

    def __init__(self, name, fn, props=None):
        self.name = name
        self.fn = fn  # fn(interp, this, args) -> value
        self.props = props  # static members (e.g. Array.isArray), or None

    def __repr__(self):
        return f"[native {self.name}]"


class BoundMethod:
    __slots__ = ("func", "this")

    def __init__(self, func, this):
        self.func = func
        self.this = this


class JSClass:
    __slots__ = ("name", "methods", "statics", "static_props", "parent")

    def __init__(self, name, methods, statics, parent=None):
        self.name = name
        self.methods = methods        # {name: JSFunction}
        self.statics = statics        # {name: JSFunction}
        self.static_props = {}
        self.parent = parent

    def find_method(self, name):
        c = self
        while c is not None:
            m = c.methods.get(name)
            if m is not None:
                return m
            c = c.parent
        return None

    def __repr__(self):
        return f"[class {self.name}]"


class ArrayBuffer:
    __slots__ = ("data",)

    def __init__(self, data: bytearray):
        self.data = data if isinstance(data, bytearray) else bytearray(data)


class TypedArray:
    __slots__ = ("mv", "fmt", "name")

    def __init__(self, mv, fmt, name):
        self.mv = mv            # memoryview cast to fmt
        self.fmt = fmt          # 'f' or 'B' or 'i' ...
        self.name = name

    @property
    def length(self):
        return len(self.mv)

    def __repr__(self):
        return f"[{self.name}({len(self.mv)})]"


class JSRegExp:
    __slots__ = ("source", "flags", "pat", "global_")

    def __init__(self, source, flags):
        self.source = source
        self.flags = flags
        pyflags = 0
        if "i" in flags:
            pyflags |= _regex.IGNORECASE
        if "m" in flags:
            pyflags |= _regex.MULTILINE
        if "s" in flags:
            pyflags |= _regex.DOTALL
        self.global_ = "g" in flags
        self.pat = _regex.compile(source, pyflags)


class JSPromiseValue:
    """An already-resolved promise (jsvm executes async synchronously)."""
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


# ---------------------------------------------------------------------------
# Errors and control-flow signals
# ---------------------------------------------------------------------------

class JSError(Exception):
    """A JS `throw` that escaped to the host."""

    def __init__(self, value):
        self.value = value
        super().__init__(js_display(value))


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


# ---------------------------------------------------------------------------
# Coercions
# ---------------------------------------------------------------------------

def truthy(v) -> bool:
    if v is UNDEFINED or v is None or v is False:
        return False
    if v is True:
        return True
    if isinstance(v, (int, float)):
        return not (v == 0 or (isinstance(v, float) and math.isnan(v)))
    if isinstance(v, str):
        return len(v) > 0
    return True


def js_str(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v.is_integer() and abs(v) < 1e21:
            return str(int(v))
        return repr(v)
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return ",".join(js_str(x) for x in v.items)
    if isinstance(v, JSObject):
        if v.klass is not None and v.klass.name == "Error":
            name = v.props.get("name", "Error")
            return f"{js_str(name)}: {js_str(v.props.get('message', ''))}"
        return "[object Object]"
    if isinstance(v, JSRegExp):
        return f"/{v.source}/{v.flags}"
    return repr(v)


def js_display(v) -> str:
    return js_str(v)


def to_number(v):
    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, (int, float)):
        return v
    if v is UNDEFINED:
        return float("nan")
    if v is None:
        return 0
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return float("nan")
    return float("nan")


def to_int32(v):
    n = to_number(v)
    if isinstance(n, float):
        if math.isnan(n) or math.isinf(n):
            return 0
        n = int(n)
    n &= 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def to_prop(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v.is_integer():
            return str(int(v))
        return js_str(v)
    return js_str(v)


def strict_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    na = isinstance(a, (int, float))
    nb = isinstance(b, (int, float))
    if na and nb:
        if isinstance(a, float) and math.isnan(a):
            return False
        if isinstance(b, float) and math.isnan(b):
            return False
        return a == b
    if na != nb:
        return False
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def loose_eq(a, b) -> bool:
    if (a is None or a is UNDEFINED) and (b is None or b is UNDEFINED):
        return True
    if isinstance(a, str) and isinstance(b, (int, float)) and \
            not isinstance(b, bool):
        return loose_eq(to_number(a), b)
    if isinstance(b, str) and isinstance(a, (int, float)) and \
            not isinstance(a, bool):
        return loose_eq(a, to_number(b))
    if isinstance(a, bool):
        return loose_eq(1 if a else 0, b)
    if isinstance(b, bool):
        return loose_eq(a, 1 if b else 0)
    return strict_eq(a, b)


# ---------------------------------------------------------------------------
# Typed arrays
# ---------------------------------------------------------------------------

_TA_SPECS = {
    "Float32Array": ("f", 4),
    "Float64Array": ("d", 8),
    "Uint8Array": ("B", 1),
    "Int8Array": ("b", 1),
    "Uint16Array": ("H", 2),
    "Int16Array": ("h", 2),
    "Uint32Array": ("I", 4),
    "Int32Array": ("i", 4),
}


def _new_typed(name, interp, args):
    fmt, itemsize = _TA_SPECS[name]
    if not args or args[0] is UNDEFINED:
        buf = ArrayBuffer(bytearray(0))
        return TypedArray(memoryview(buf.data).cast(fmt), fmt, name)
    a0 = args[0]
    if isinstance(a0, (int, float)) and not isinstance(a0, bool):
        n = int(a0)
        buf = ArrayBuffer(bytearray(n * itemsize))
        return TypedArray(memoryview(buf.data).cast(fmt), fmt, name)
    if isinstance(a0, ArrayBuffer):
        byte_off = int(to_number(args[1])) if len(args) > 1 and \
            args[1] is not UNDEFINED else 0
        mv = memoryview(a0.data)
        if len(args) > 2 and args[2] is not UNDEFINED:
            count = int(to_number(args[2]))
            mv = mv[byte_off:byte_off + count * itemsize]
        else:
            mv = mv[byte_off:]
        return TypedArray(mv.cast(fmt), fmt, name)
    if isinstance(a0, TypedArray):
        src = a0.mv
        buf = bytearray(len(src) * itemsize)
        out = memoryview(buf).cast(fmt)
        if a0.fmt == fmt:
            out[:] = src
        else:
            # cross-dtype construction converts per element; int targets
            # truncate toward zero (JS ToIntegerOrInfinity)
            for i in range(len(src)):
                out[i] = src[i] if fmt in "fd" else int(src[i])
        return TypedArray(out, fmt, name)
    if isinstance(a0, JSArray):
        n = len(a0.items)
        buf = bytearray(n * itemsize)
        out = memoryview(buf).cast(fmt)
        for i, v in enumerate(a0.items):
            x = to_number(v)
            out[i] = x if fmt in "fd" else int(x)
        return TypedArray(out, fmt, name)
    raise JSError(f"cannot construct {name} from {type(a0).__name__}")


def _ta_method(ta: TypedArray, name: str, interp):
    fmt = ta.fmt
    ctor = ta.name

    if name == "subarray":
        def subarray(interp_, this, args):
            n = len(ta.mv)
            a = int(to_number(args[0])) if args else 0
            b = int(to_number(args[1])) if len(args) > 1 and \
                args[1] is not UNDEFINED else n
            a = max(0, a + n) if a < 0 else min(a, n)
            b = max(0, b + n) if b < 0 else min(b, n)
            return TypedArray(ta.mv[a:max(a, b)], fmt, ctor)
        return NativeFunction("subarray", subarray)

    if name == "slice":
        def slice_(interp_, this, args):
            n = len(ta.mv)
            a = int(to_number(args[0])) if args else 0
            b = int(to_number(args[1])) if len(args) > 1 and \
                args[1] is not UNDEFINED else n
            a = max(0, a + n) if a < 0 else min(a, n)
            b = max(0, b + n) if b < 0 else min(b, n)
            src = ta.mv[a:max(a, b)]
            buf = bytearray(src.nbytes)
            out = memoryview(buf).cast(fmt)
            out[:] = src
            return TypedArray(out, fmt, ctor)
        return NativeFunction("slice", slice_)

    if name == "set":
        def set_(interp_, this, args):
            src = args[0]
            off = int(to_number(args[1])) if len(args) > 1 and \
                args[1] is not UNDEFINED else 0
            if isinstance(src, TypedArray):
                if src.fmt == fmt:
                    ta.mv[off:off + len(src.mv)] = src.mv
                else:
                    for i in range(len(src.mv)):
                        ta.mv[off + i] = src.mv[i]
            elif isinstance(src, JSArray):
                for i, v in enumerate(src.items):
                    x = to_number(v)
                    ta.mv[off + i] = x if fmt in "fd" else int(x)
            else:
                raise JSError("TypedArray.set: bad source")
            return UNDEFINED
        return NativeFunction("set", set_)

    if name == "fill":
        def fill(interp_, this, args):
            x = to_number(args[0]) if args else 0
            v = x if fmt in "fd" else int(x)
            for i in range(len(ta.mv)):
                ta.mv[i] = v
            return ta
        return NativeFunction("fill", fill)

    if name == "indexOf":
        def index_of(interp_, this, args):
            x = to_number(args[0]) if args else float("nan")
            for i in range(len(ta.mv)):
                if ta.mv[i] == x:
                    return i
            return -1
        return NativeFunction("indexOf", index_of)

    if name == "map":
        def map_(interp_, this, args):
            fn = args[0]
            out = JSArray([interp_.call(fn, UNDEFINED, [ta.mv[i], i, ta])
                           for i in range(len(ta.mv))])
            return out
        return NativeFunction("map", map_)

    if name == "join":
        def join(interp_, this, args):
            sep = js_str(args[0]) if args and args[0] is not UNDEFINED else ","
            return sep.join(js_str(ta.mv[i]) for i in range(len(ta.mv)))
        return NativeFunction("join", join)

    if name == "reduce":
        def reduce_(interp_, this, args):
            fn = args[0]
            n = len(ta.mv)
            if len(args) > 1:
                acc, start = args[1], 0
            else:
                acc, start = ta.mv[0], 1
            for i in range(start, n):
                acc = interp_.call(fn, UNDEFINED, [acc, ta.mv[i], i, ta])
            return acc
        return NativeFunction("reduce", reduce_)

    return None


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------

_NO_THIS = object()


class Environment:
    __slots__ = ("vars", "parent", "this_val")

    def __init__(self, parent=None, this_val=_NO_THIS):
        self.vars = {}
        self.parent = parent
        self.this_val = this_val

    def get(self, name):
        e = self
        while e is not None:
            v = e.vars.get(name, _MISSING)
            if v is not _MISSING:
                return v
            e = e.parent
        raise JSError(_make_error("ReferenceError",
                                  f"{name} is not defined"))

    def has(self, name) -> bool:
        e = self
        while e is not None:
            if name in e.vars:
                return True
            e = e.parent
        return False

    def set(self, name, value):
        e = self
        while e is not None:
            if name in e.vars:
                e.vars[name] = value
                return
            e = e.parent
        raise JSError(_make_error("ReferenceError",
                                  f"{name} is not defined"))

    def define(self, name, value):
        self.vars[name] = value

    def lookup_this(self):
        e = self
        while e is not None:
            if e.this_val is not _NO_THIS:
                return e.this_val
            e = e.parent
        return UNDEFINED


_ERROR_CLASS = JSClass("Error", {}, {})


def _make_error(name: str, message: str) -> JSObject:
    return JSObject({"name": name, "message": message}, _ERROR_CLASS)


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class Interpreter:
    def __init__(self, extra_globals: dict | None = None):
        self.globals = Environment(this_val=UNDEFINED)
        self._console_lines: list[str] = []
        self._install_builtins()
        if extra_globals:
            for k, v in extra_globals.items():
                self.globals.define(k, v)

        self._stmt = {
            "ExprStmt": self._st_expr, "VarDecl": self._st_var,
            "FuncDecl": self._st_func, "ClassDecl": self._st_class,
            "Return": self._st_return, "If": self._st_if,
            "For": self._st_for, "ForOf": self._st_forof,
            "ForIn": self._st_forin, "While": self._st_while,
            "DoWhile": self._st_dowhile, "Block": self._st_block,
            "Break": self._st_break, "Continue": self._st_continue,
            "Throw": self._st_throw, "Try": self._st_try,
            "Empty": lambda n, e: None,
        }
        self._expr = {
            "Num": lambda n, e: n[1], "Str": lambda n, e: n[1],
            "Bool": lambda n, e: n[1], "Null": lambda n, e: None,
            "Undef": lambda n, e: UNDEFINED,
            "Ident": lambda n, e: e.get(n[1]),
            "This": lambda n, e: e.lookup_this(),
            "Regex": lambda n, e: JSRegExp(n[1], n[2]),
            "Array": self._ex_array, "Object": self._ex_object,
            "Arrow": self._ex_arrow, "Func": self._ex_func,
            "Bin": self._ex_bin, "Logic": self._ex_logic,
            "Unary": self._ex_unary, "Update": self._ex_update,
            "Assign": self._ex_assign, "Cond": self._ex_cond,
            "Call": self._ex_call, "New": self._ex_new,
            "Member": self._ex_member, "Index": self._ex_index,
            "Await": self._ex_await, "Seq": self._ex_seq,
            "ClassDecl": self._ex_classexpr,
        }

    # -- public API ---------------------------------------------------------

    def run(self, src: str):
        program = parse(src)
        result = None
        for st in program:
            result = self.exec_stmt(st, self.globals)
        return result

    def call(self, fn, this, args):
        """Call a JS value with JS-value args."""
        while isinstance(fn, JSPromiseValue):
            fn = fn.value
        if isinstance(fn, BoundMethod):
            return self.call(fn.func, fn.this, args)
        if isinstance(fn, NativeFunction):
            return fn.fn(self, this, args)
        if isinstance(fn, JSFunction):
            env = Environment(
                fn.env, _NO_THIS if fn.is_arrow else this)
            self._bind_params(fn.params, args, env)
            if fn.is_expr_body:
                result = self.eval(fn.body, env)
            else:
                result = UNDEFINED
                try:
                    for st in fn.body[1]:
                        self.exec_stmt(st, env)
                except _Return as r:
                    result = r.value
            if fn.is_async and not isinstance(result, JSPromiseValue):
                # an async function's caller always receives a promise
                return JSPromiseValue(result)
            return result
        if isinstance(fn, JSClass):
            raise JSError(_make_error(
                "TypeError", f"class {fn.name} must be called with new"))
        raise JSError(_make_error(
            "TypeError", f"{js_str(fn)} is not a function"))

    def construct(self, cls, args):
        if isinstance(cls, NativeFunction):
            return cls.fn(self, _NEW_TARGET, args)
        if not isinstance(cls, JSClass):
            raise JSError(_make_error(
                "TypeError", f"{js_str(cls)} is not a constructor"))
        obj = JSObject({}, cls)
        ctor = cls.find_method("constructor")
        if ctor is not None:
            self.call(ctor, obj, args)
        elif cls is _ERROR_CLASS or (cls.parent is _ERROR_CLASS):
            obj.props["name"] = cls.name
            obj.props["message"] = js_str(args[0]) if args else ""
        return obj

    # convenience wrappers that convert host <-> JS values
    def call_function(self, fn, *host_args):
        return js_to_host(self.call(fn, UNDEFINED,
                                    [host_to_js(a) for a in host_args]))

    def call_method(self, obj, name, *host_args, raw=False):
        m = self.get_member(obj, name)
        r = self.call(m, obj, [host_to_js(a) for a in host_args])
        while isinstance(r, JSPromiseValue):  # host boundary awaits
            r = r.value
        return r if raw else js_to_host(r)

    def new_instance(self, cls, *host_args):
        return self.construct(cls, [host_to_js(a) for a in host_args])

    @property
    def console_output(self) -> list[str]:
        return self._console_lines

    # -- statements ---------------------------------------------------------

    def exec_stmt(self, node, env):
        return self._stmt[node[0]](node, env)

    def _st_expr(self, node, env):
        return self.eval(node[1], env)

    def _st_var(self, node, env):
        for pat, init in node[2]:
            value = self.eval(init, env) if init is not None else UNDEFINED
            self._bind_pattern(pat, value, env)
        return None

    def _st_func(self, node, env):
        _, name, params, body, is_async = node
        env.define(name, JSFunction(name, params, body, False, env, False,
                                    is_async))
        return None

    def _make_class(self, node, env):
        _, name, super_expr, members = node
        parent = None
        if super_expr is not None:
            parent = self.eval(super_expr, env)
            if not isinstance(parent, JSClass):
                raise JSError(_make_error("TypeError",
                                          "superclass is not a class"))
        methods, statics = {}, {}
        for mname, params, body, is_static, is_async in members:
            fn = JSFunction(mname, params, body, False, env, False, is_async)
            (statics if is_static else methods)[mname] = fn
        return JSClass(name, methods, statics, parent)

    def _st_class(self, node, env):
        cls = self._make_class(node, env)
        env.define(cls.name, cls)
        return None

    def _ex_classexpr(self, node, env):
        return self._make_class(node, env)

    def _st_return(self, node, env):
        raise _Return(self.eval(node[1], env) if node[1] is not None
                      else UNDEFINED)

    def _st_if(self, node, env):
        if truthy(self.eval(node[1], env)):
            self.exec_stmt(node[2], env)
        elif node[3] is not None:
            self.exec_stmt(node[3], env)
        return None

    def _st_for(self, node, env):
        _, init, test, update, body = node
        loop_env = Environment(env)
        names = []
        if init is not None:
            self.exec_stmt(init, loop_env)
            # spec 13.7.4.7: `for (let ...)` gets a fresh binding copied per
            # iteration (before the first test, and again before each
            # update), so closures made in the body capture that iteration's
            # value — for(let i...){fns.push(()=>i)} yields 0,1,2 not 3,3,3
            if init[0] == "VarDecl" and init[1] in ("let", "const"):
                names = [p[1] for p, _ in init[2] if p[0] == "IdPat"]

        def fresh(prev):
            nxt = Environment(env)
            for n in names:
                nxt.define(n, prev.get(n))
            return nxt

        cur = fresh(loop_env) if names else loop_env
        ev = self.eval
        ex = self.exec_stmt
        while test is None or truthy(ev(test, cur)):
            try:
                ex(body, cur)
            except _Break:
                break
            except _Continue:
                pass
            if names:
                cur = fresh(cur)
            if update is not None:
                ev(update, cur)
        return None

    def _iterate(self, value):
        if isinstance(value, JSArray):
            return list(value.items)
        if isinstance(value, TypedArray):
            return [value.mv[i] for i in range(len(value.mv))]
        if isinstance(value, str):
            return list(value)
        if isinstance(value, JSObject):
            ent = value.props.get("__iter_items__")
            if isinstance(ent, JSArray):
                return list(ent.items)
        raise JSError(_make_error("TypeError",
                                  f"{js_str(value)} is not iterable"))

    def _st_forof(self, node, env):
        _, kind, pat, iterable, body = node
        seq = self._iterate(self.eval(iterable, env))
        for item in seq:
            it_env = Environment(env)
            self._bind_pattern(pat, item, it_env)
            try:
                self.exec_stmt(body, it_env)
            except _Break:
                break
            except _Continue:
                continue
        return None

    def _st_forin(self, node, env):
        _, kind, pat, obj_expr, body = node
        obj = self.eval(obj_expr, env)
        if isinstance(obj, JSObject):
            keys = list(obj.props.keys())
        elif isinstance(obj, JSArray):
            keys = [str(i) for i in range(len(obj.items))]
        else:
            keys = []
        for k in keys:
            it_env = Environment(env)
            self._bind_pattern(pat, k, it_env)
            try:
                self.exec_stmt(body, it_env)
            except _Break:
                break
            except _Continue:
                continue
        return None

    def _st_while(self, node, env):
        _, test, body = node
        while truthy(self.eval(test, env)):
            try:
                self.exec_stmt(body, env)
            except _Break:
                break
            except _Continue:
                continue
        return None

    def _st_dowhile(self, node, env):
        _, body, test = node
        while True:
            try:
                self.exec_stmt(body, env)
            except _Break:
                break
            except _Continue:
                pass
            if not truthy(self.eval(test, env)):
                break
        return None

    def _st_block(self, node, env):
        block_env = Environment(env)
        for st in node[1]:
            self.exec_stmt(st, block_env)
        return None

    def _st_break(self, node, env):
        raise _Break()

    def _st_continue(self, node, env):
        raise _Continue()

    def _st_throw(self, node, env):
        raise JSError(self.eval(node[1], env))

    def _st_try(self, node, env):
        _, block, param, handler, final = node
        try:
            self.exec_stmt(block, env)
        except JSError as err:
            if handler is not None:
                h_env = Environment(env)
                if param is not None:
                    self._bind_pattern(param, err.value, h_env)
                self.exec_stmt(handler, h_env)
            elif final is None:
                raise
        finally:
            if final is not None:
                self.exec_stmt(final, env)
        return None

    # -- binding ------------------------------------------------------------

    def _bind_pattern(self, pat, value, env):
        kind = pat[0]
        if kind == "DefaultPat":
            # default expressions see earlier bindings: (a, b = a + 1) => ...
            if value is UNDEFINED:
                value = self.eval(pat[2], env)
            self._bind_pattern(pat[1], value, env)
            return
        if kind == "IdPat":
            env.define(pat[1], value)
            return
        if kind == "ArrayPat":
            seq = self._iterate(value) if not isinstance(value, JSArray) \
                else value.items
            for i, sub in enumerate(pat[1]):
                if sub is None:          # elision hole: [a,,b]
                    continue
                if sub[0] == "RestPat":
                    self._bind_pattern(sub[1], JSArray(list(seq[i:])), env)
                    return
                self._bind_pattern(sub, seq[i] if i < len(seq) else UNDEFINED,
                                   env)
            return
        if kind == "ObjectPat":
            for key, sub in pat[1]:
                self._bind_pattern(sub, self.get_member(value, key), env)
            return
        raise JSSyntaxError(f"bad pattern {kind}")

    def _bind_params(self, params, args, env):
        for i, pat in enumerate(params):
            if pat[0] == "RestPat":
                self._bind_pattern(pat[1], JSArray(list(args[i:])), env)
                return
            self._bind_pattern(pat, args[i] if i < len(args) else UNDEFINED,
                               env)

    # -- expressions --------------------------------------------------------

    def eval(self, node, env):
        return self._expr[node[0]](node, env)

    def _ex_seq(self, node, env):
        result = UNDEFINED
        for e in node[1]:
            result = self.eval(e, env)
        return result

    def _ex_array(self, node, env):
        items = []
        for e in node[1]:
            if e[0] == "Spread":
                items.extend(self._iterate(self.eval(e[1], env)))
            else:
                items.append(self.eval(e, env))
        return JSArray(items)

    def _ex_object(self, node, env):
        props = {}
        for key, val in node[1]:
            props[key] = self.eval(val, env)
        return JSObject(props)

    def _ex_arrow(self, node, env):
        _, params, body, is_expr, is_async = node
        return JSFunction(None, params, body, is_expr, env, True, is_async)

    def _ex_func(self, node, env):
        _, name, params, body, is_async = node
        return JSFunction(name, params, body, False, env, False, is_async)

    def _ex_cond(self, node, env):
        return self.eval(node[2], env) if truthy(self.eval(node[1], env)) \
            else self.eval(node[3], env)

    def _ex_logic(self, node, env):
        op = node[1]
        left = self.eval(node[2], env)
        if op == "&&":
            return self.eval(node[3], env) if truthy(left) else left
        if op == "||":
            return left if truthy(left) else self.eval(node[3], env)
        # ??
        return self.eval(node[3], env) if (left is None or left is UNDEFINED) \
            else left

    def _ex_await(self, node, env):
        v = self.eval(node[1], env)
        while isinstance(v, JSPromiseValue):
            v = v.value
        return v

    def _ex_unary(self, node, env):
        op = node[1]
        if op == "typeof":
            operand = node[2]
            if operand[0] == "Ident" and not env.has(operand[1]):
                return "undefined"
            return js_typeof(self.eval(operand, env))
        v = self.eval(node[2], env)
        if op == "!":
            return not truthy(v)
        if op == "-":
            n = to_number(v)
            return -n
        if op == "+":
            return to_number(v)
        if op == "~":
            return ~to_int32(v)
        if op == "void":
            return UNDEFINED
        raise JSSyntaxError(f"unary {op}")

    def _ex_bin(self, node, env):
        return js_binop(node[1], self.eval(node[2], env),
                        self.eval(node[3], env))

    def _resolve_ref(self, target, env):
        """Evaluate an assignment target ONCE; returns (kind, base, key)."""
        k = target[0]
        if k == "Ident":
            return ("var", env, target[1])
        if k == "Member":
            return ("member", self.eval(target[1], env), target[2])
        if k == "Index":
            obj = self.eval(target[1], env)
            return ("index", obj, self.eval(target[2], env))
        raise JSSyntaxError("bad assignment target")

    def _ref_get(self, ref):
        kind, base, key = ref
        if kind == "var":
            return base.get(key)
        if kind == "member":
            return self.get_member(base, key)
        return self.get_index(base, key)

    def _ref_set(self, ref, value):
        kind, base, key = ref
        if kind == "var":
            base.set(key, value)
        elif kind == "member":
            self.set_member(base, key, value)
        else:
            self.set_index(base, key, value)

    def _ex_update(self, node, env):
        _, op, prefix, target = node
        ref = self._resolve_ref(target, env)
        old = to_number(self._ref_get(ref))
        new = old + 1 if op == "++" else old - 1
        self._ref_set(ref, new)
        return new if prefix else old

    def _ex_assign(self, node, env):
        _, op, target, value_node = node
        if op == "=":
            value = self.eval(value_node, env)
            # fast path: plain variable assignment
            if target[0] == "Ident":
                env.set(target[1], value)
                return value
            ref = self._resolve_ref(target, env)
            self._ref_set(ref, value)
            return value
        ref = self._resolve_ref(target, env)
        if op in ("&&=", "||=", "??="):
            cur = self._ref_get(ref)
            if op == "&&=" and not truthy(cur):
                return cur
            if op == "||=" and truthy(cur):
                return cur
            if op == "??=" and cur is not None and cur is not UNDEFINED:
                return cur
            value = self.eval(value_node, env)
        else:
            cur = self._ref_get(ref)
            rhs = self.eval(value_node, env)
            value = js_binop(op[:-1], cur, rhs)
        self._ref_set(ref, value)
        return value

    def _ex_call(self, node, env):
        # spec evaluation order: resolve the callee reference (and GetValue
        # it) BEFORE evaluating arguments — `f(f = g)` calls the original f
        callee = node[1]
        ck = callee[0]
        if ck == "Member":
            obj = self.eval(callee[1], env)
            fn = self.get_member(obj, callee[2])
            args = self._eval_args(node[2], env)
            if isinstance(fn, BoundMethod):
                return self.call(fn.func, fn.this, args)
            return self.call(fn, obj, args)
        if ck == "Index":
            obj = self.eval(callee[1], env)
            fn = self.get_index(obj, self.eval(callee[2], env))
            args = self._eval_args(node[2], env)
            if isinstance(fn, BoundMethod):
                return self.call(fn.func, fn.this, args)
            return self.call(fn, obj, args)
        fn = self.eval(callee, env)
        args = self._eval_args(node[2], env)
        return self.call(fn, UNDEFINED, args)

    def _eval_args(self, arg_nodes, env):
        args = []
        for a in arg_nodes:
            if a[0] == "Spread":
                args.extend(self._iterate(self.eval(a[1], env)))
            else:
                args.append(self.eval(a, env))
        return args

    def _ex_new(self, node, env):
        cls = self.eval(node[1], env)
        args = self._eval_args(node[2], env)
        return self.construct(cls, args)

    def _ex_member(self, node, env):
        return self.get_member(self.eval(node[1], env), node[2])

    def _ex_index(self, node, env):
        obj = self.eval(node[1], env)
        return self.get_index(obj, self.eval(node[2], env))

    # -- member / index protocol -------------------------------------------

    def get_member(self, obj, name):
        if isinstance(obj, JSObject):
            v = obj.props.get(name, _MISSING)
            if v is not _MISSING:
                return v
            if obj.klass is not None:
                m = obj.klass.find_method(name)
                if m is not None:
                    return BoundMethod(m, obj)
            return UNDEFINED
        if isinstance(obj, JSArray):
            if name == "length":
                return len(obj.items)
            m = _ARRAY_METHODS.get(name)
            if m is not None:
                return BoundMethod(NativeFunction(name, m), obj)
            return UNDEFINED
        if isinstance(obj, str):
            if name == "length":
                return len(obj)
            m = _STRING_METHODS.get(name)
            if m is not None:
                return BoundMethod(NativeFunction(name, m), obj)
            return UNDEFINED
        if isinstance(obj, TypedArray):
            if name == "length":
                return len(obj.mv)
            if name == "buffer":
                return ArrayBuffer(bytearray(obj.mv.tobytes()))
            if name == "byteLength":
                return obj.mv.nbytes
            m = _ta_method(obj, name, self)
            if m is not None:
                return m
            return UNDEFINED
        if isinstance(obj, JSClass):
            if name in obj.statics:
                return obj.statics[name]
            if name in obj.static_props:
                return obj.static_props[name]
            if name == "name":
                return obj.name
            if obj.parent is not None:
                return self.get_member(obj.parent, name)
            return UNDEFINED
        if isinstance(obj, JSRegExp):
            if name == "source":
                return obj.source
            if name == "flags":
                return obj.flags
            m = _REGEX_METHODS.get(name)
            if m is not None:
                return BoundMethod(NativeFunction(name, m), obj)
            return UNDEFINED
        if isinstance(obj, ArrayBuffer):
            if name == "byteLength":
                return len(obj.data)
            return UNDEFINED
        if isinstance(obj, JSPromiseValue):
            if name == "then":
                def then(interp, this, args):
                    r = interp.call(args[0], UNDEFINED, [obj.value])
                    # .then flattens: a callback returning a promise must
                    # not produce a promise-of-promise (Promise/A+ 2.3.2)
                    return r if isinstance(r, JSPromiseValue) \
                        else JSPromiseValue(r)
                return NativeFunction("then", then)
            if name == "catch":
                return NativeFunction("catch", lambda i, t, a: obj)
            return UNDEFINED
        if isinstance(obj, (int, float)) and not isinstance(obj, bool):
            m = _NUMBER_METHODS.get(name)
            if m is not None:
                return BoundMethod(NativeFunction(name, m), obj)
            return UNDEFINED
        if isinstance(obj, (JSFunction, NativeFunction)):
            props = getattr(obj, "props", None)  # Array.isArray etc.
            if props is not None and name in props:
                return props[name]
            if name == "name":
                return obj.name or ""
            if name == "call":
                def call_(interp, this, args):
                    return interp.call(obj, args[0] if args else UNDEFINED,
                                       args[1:])
                return NativeFunction("call", call_)
            if name == "apply":
                def apply_(interp, this, args):
                    rest = args[1].items if len(args) > 1 and \
                        isinstance(args[1], JSArray) else []
                    return interp.call(obj, args[0] if args else UNDEFINED,
                                       rest)
                return NativeFunction("apply", apply_)
            if name == "bind":
                def bind_(interp, this, args):
                    bt = args[0] if args else UNDEFINED
                    return BoundMethod(obj, bt)
                return NativeFunction("bind", bind_)
            return UNDEFINED
        if obj is UNDEFINED or obj is None:
            raise JSError(_make_error(
                "TypeError",
                f"cannot read properties of {js_str(obj)} "
                f"(reading '{name}')"))
        return UNDEFINED

    def set_member(self, obj, name, value):
        if isinstance(obj, JSObject):
            obj.props[name] = value
            return
        if isinstance(obj, JSClass):
            obj.static_props[name] = value
            return
        if isinstance(obj, JSArray) and name == "length":
            n = int(to_number(value))
            del obj.items[n:]
            return
        raise JSError(_make_error(
            "TypeError", f"cannot set property '{name}' on "
            f"{js_typeof(obj)}"))

    def get_index(self, obj, key):
        tk = type(key)
        if isinstance(obj, TypedArray):
            if tk is int or (tk is float and key.is_integer()):
                i = int(key)
                if 0 <= i < len(obj.mv):
                    return obj.mv[i]
                return UNDEFINED
            return self.get_member(obj, to_prop(key))
        if isinstance(obj, JSArray):
            if tk is int or (tk is float and key.is_integer()):
                i = int(key)
                if 0 <= i < len(obj.items):
                    return obj.items[i]
                return UNDEFINED
            return self.get_member(obj, to_prop(key))
        if isinstance(obj, JSObject):
            v = obj.props.get(to_prop(key), _MISSING)
            if v is not _MISSING:
                return v
            return self.get_member(obj, to_prop(key))
        if isinstance(obj, str):
            if tk is int or (tk is float and key.is_integer()):
                i = int(key)
                if 0 <= i < len(obj):
                    return obj[i]
                return UNDEFINED
            return self.get_member(obj, to_prop(key))
        return self.get_member(obj, to_prop(key))

    def set_index(self, obj, key, value):
        tk = type(key)
        if isinstance(obj, TypedArray):
            i = int(key)
            x = to_number(value)
            obj.mv[i] = x if obj.fmt in "fd" else int(x)
            return
        if isinstance(obj, JSArray):
            if tk is int or (tk is float and key.is_integer()):
                i = int(key)
                items = obj.items
                if i == len(items):
                    items.append(value)
                elif 0 <= i < len(items):
                    items[i] = value
                else:
                    while len(items) < i:
                        items.append(UNDEFINED)
                    items.append(value)
                return
        if isinstance(obj, JSObject):
            obj.props[to_prop(key)] = value
            return
        raise JSError(_make_error(
            "TypeError", f"cannot index-assign on {js_typeof(obj)}"))

    # -- builtins -----------------------------------------------------------

    def _install_builtins(self):
        g = self.globals

        g.define("undefined", UNDEFINED)
        g.define("Infinity", float("inf"))
        g.define("NaN", float("nan"))
        g.define("globalThis", JSObject())

        math_obj = JSObject({
            "PI": math.pi, "E": math.e, "LN2": math.log(2),
            "sqrt": NativeFunction("sqrt", lambda i, t, a: math.sqrt(
                to_number(a[0])) if to_number(a[0]) >= 0 else float("nan")),
            "exp": NativeFunction("exp", lambda i, t, a: math.exp(
                min(to_number(a[0]), 709.0)) if not math.isnan(
                to_number(a[0])) else float("nan")),
            "tanh": NativeFunction("tanh",
                                   lambda i, t, a: math.tanh(to_number(a[0]))),
            "log": NativeFunction("log", lambda i, t, a: math.log(
                to_number(a[0])) if to_number(a[0]) > 0 else float("-inf")),
            "abs": NativeFunction("abs", lambda i, t, a: abs(to_number(a[0]))),
            "floor": NativeFunction("floor",
                                    lambda i, t, a: math.floor(
                                        to_number(a[0]))),
            "ceil": NativeFunction("ceil",
                                   lambda i, t, a: math.ceil(to_number(a[0]))),
            "round": NativeFunction("round", lambda i, t, a: math.floor(
                to_number(a[0]) + 0.5)),
            "trunc": NativeFunction("trunc",
                                    lambda i, t, a: math.trunc(
                                        to_number(a[0]))),
            "pow": NativeFunction("pow", lambda i, t, a: to_number(a[0]) **
                                  to_number(a[1])),
            "max": NativeFunction("max", lambda i, t, a: max(
                (to_number(x) for x in a), default=float("-inf"))),
            "min": NativeFunction("min", lambda i, t, a: min(
                (to_number(x) for x in a), default=float("inf"))),
            "sign": NativeFunction("sign", lambda i, t, a: (
                0 if to_number(a[0]) == 0 else math.copysign(
                    1, to_number(a[0])))),
            "cos": NativeFunction("cos",
                                  lambda i, t, a: math.cos(to_number(a[0]))),
            "sin": NativeFunction("sin",
                                  lambda i, t, a: math.sin(to_number(a[0]))),
            "random": NativeFunction("random", _no_random),
        })
        g.define("Math", math_obj)

        for ta_name in _TA_SPECS:
            g.define(ta_name, NativeFunction(
                ta_name,
                lambda i, t, a, _n=ta_name: _new_typed(_n, i, a)))

        g.define("ArrayBuffer", NativeFunction(
            "ArrayBuffer",
            lambda i, t, a: ArrayBuffer(bytearray(int(to_number(a[0]))
                                                  if a else 0))))

        obj_ns = JSObject({
            "entries": NativeFunction("entries", _object_entries),
            "keys": NativeFunction("keys", _object_keys),
            "values": NativeFunction("values", _object_values),
            "assign": NativeFunction("assign", _object_assign),
            "freeze": NativeFunction("freeze", lambda i, t, a: a[0]),
        })
        g.define("Object", obj_ns)

        def array_ctor(interp, this, args):
            # Array(n) / new Array(n) -> n holes; otherwise the elements
            if len(args) == 1 and isinstance(args[0], (int, float)) \
                    and not isinstance(args[0], bool):
                return JSArray([UNDEFINED] * int(args[0]))
            return JSArray(list(args))

        g.define("Array", NativeFunction("Array", array_ctor, props={
            "isArray": NativeFunction(
                "isArray", lambda i, t, a: isinstance(a[0], JSArray)
                if a else False),
            "from": NativeFunction("from", _array_from),
            "of": NativeFunction("of", lambda i, t, a: JSArray(list(a))),
        }))

        # String(x)/Number(x)/Boolean(x) are callable conversion functions
        # with static props, mirroring Array above
        g.define("String", NativeFunction(
            "String", lambda i, t, a: js_str(a[0]) if a else "", props={
                "fromCharCode": NativeFunction(
                    "fromCharCode",
                    lambda i, t, a: "".join(chr(int(to_number(x)) & 0xFFFF)
                                            for x in a)),
                "fromCodePoint": NativeFunction(
                    "fromCodePoint",
                    lambda i, t, a: "".join(chr(int(to_number(x)))
                                            for x in a)),
            }))
        g.define("Boolean", NativeFunction(
            "Boolean", lambda i, t, a: truthy(a[0]) if a else False))

        num_props = {
            "isInteger": NativeFunction(
                "isInteger", lambda i, t, a: isinstance(a[0], int) or (
                    isinstance(a[0], float) and a[0].is_integer())
                if a and not isinstance(a[0], bool) else False),
            "isFinite": NativeFunction(
                "isFinite", lambda i, t, a: isinstance(a[0], (int, float)) and
                not isinstance(a[0], bool) and math.isfinite(a[0])
                if a else False),
            "isNaN": NativeFunction(
                "isNaN", lambda i, t, a: isinstance(a[0], float) and
                math.isnan(a[0]) if a else False),
            "MAX_SAFE_INTEGER": 2 ** 53 - 1,
            "POSITIVE_INFINITY": float("inf"),
            "NEGATIVE_INFINITY": float("-inf"),
            "EPSILON": 2.220446049250313e-16,
        }
        g.define("Number", NativeFunction(
            "Number", lambda i, t, a: to_number(a[0]) if a else 0,
            props=num_props))

        json_ns = JSObject({
            "parse": NativeFunction(
                "parse", lambda i, t, a: host_to_js(json.loads(js_str(a[0])))),
            "stringify": NativeFunction(
                "stringify",
                lambda i, t, a: json.dumps(js_to_host(a[0]))),
        })
        g.define("JSON", json_ns)

        g.define("isNaN", NativeFunction(
            "isNaN", lambda i, t, a: (
                lambda n: isinstance(n, float) and math.isnan(n))(
                to_number(a[0]) if a else float("nan"))))
        g.define("isFinite", NativeFunction(
            "isFinite", lambda i, t, a: (
                lambda n: isinstance(n, (int, float)) and math.isfinite(n))(
                to_number(a[0]) if a else float("nan"))))
        g.define("parseInt", NativeFunction("parseInt", _parse_int))
        g.define("parseFloat", NativeFunction("parseFloat", _parse_float))

        g.define("Error", _ERROR_CLASS)
        for ename in ("TypeError", "RangeError", "ReferenceError"):
            g.define(ename, JSClass(ename, {}, {}, _ERROR_CLASS))

        def console_log(interp, this, args):
            line = " ".join(js_str(a) for a in args)
            interp._console_lines.append(line)
            return UNDEFINED

        g.define("console", JSObject({
            "log": NativeFunction("log", console_log),
            "warn": NativeFunction("warn", console_log),
            "error": NativeFunction("error", console_log),
        }))

        def text_encoder_ctor(interp, this, args):
            def encode(i2, t2, a2):
                raw = js_str(a2[0]) if a2 else ""
                data = raw.encode("utf-8")
                buf = bytearray(data)
                return TypedArray(memoryview(buf).cast("B"), "B",
                                  "Uint8Array")
            return JSObject({"encode": NativeFunction("encode", encode)})

        def text_decoder_ctor(interp, this, args):
            def decode(i2, t2, a2):
                src = a2[0] if a2 else None
                if isinstance(src, TypedArray):
                    return src.mv.tobytes().decode("utf-8", errors="replace")
                if isinstance(src, ArrayBuffer):
                    return bytes(src.data).decode("utf-8", errors="replace")
                if src is None or src is UNDEFINED:
                    return ""
                raise JSError("TextDecoder.decode: bad source")
            return JSObject({"decode": NativeFunction("decode", decode)})

        g.define("TextEncoder", NativeFunction("TextEncoder",
                                               text_encoder_ctor))
        g.define("TextDecoder", NativeFunction("TextDecoder",
                                               text_decoder_ctor))

        promise_ns = JSObject({
            "all": NativeFunction("all", _promise_all),
            "resolve": NativeFunction(
                "resolve", lambda i, t, a: JSPromiseValue(
                    a[0] if a else UNDEFINED)),
        })
        g.define("Promise", promise_ns)

        g.define("RegExp", NativeFunction(
            "RegExp", lambda i, t, a: JSRegExp(
                js_str(a[0]) if a else "",
                js_str(a[1]) if len(a) > 1 and a[1] is not UNDEFINED
                else "")))


_NEW_TARGET = object()


def _no_random(interp, this, args):
    raise JSError(_make_error(
        "Error", "Math.random is disabled in jsvm (deterministic tests)"))


def js_binop(op, a, b):
    if op == "+":
        if isinstance(a, str) or isinstance(b, str):
            return js_str(a) + js_str(b)
        return to_number(a) + to_number(b)
    if op == "-":
        return to_number(a) - to_number(b)
    if op == "*":
        return to_number(a) * to_number(b)
    if op == "/":
        x, y = to_number(a), to_number(b)
        if y == 0:
            if x == 0 or (isinstance(x, float) and math.isnan(x)):
                return float("nan")
            neg = (x < 0) != (isinstance(y, float) and
                              math.copysign(1, y) < 0)
            return float("-inf") if neg else float("inf")
        return x / y
    if op == "%":
        x, y = to_number(a), to_number(b)
        if y == 0:
            return float("nan")
        r = math.fmod(x, y)
        if isinstance(x, int) and isinstance(y, int):
            return int(r)
        return r
    if op == "**":
        return to_number(a) ** to_number(b)
    if op == "===":
        return strict_eq(a, b)
    if op == "!==":
        return not strict_eq(a, b)
    if op == "==":
        return loose_eq(a, b)
    if op == "!=":
        return not loose_eq(a, b)
    if op in ("<", ">", "<=", ">="):
        if isinstance(a, str) and isinstance(b, str):
            x, y = a, b
        else:
            x, y = to_number(a), to_number(b)
            if (isinstance(x, float) and math.isnan(x)) or \
                    (isinstance(y, float) and math.isnan(y)):
                return False
        if op == "<":
            return x < y
        if op == ">":
            return x > y
        if op == "<=":
            return x <= y
        return x >= y
    if op == "&":
        return to_int32(to_int32(a) & to_int32(b))
    if op == "|":
        return to_int32(to_int32(a) | to_int32(b))
    if op == "^":
        return to_int32(to_int32(a) ^ to_int32(b))
    if op == "<<":
        return to_int32(to_int32(a) << (to_int32(b) & 31))
    if op == ">>":
        return to_int32(a) >> (to_int32(b) & 31)
    if op == ">>>":
        return (to_int32(a) & 0xFFFFFFFF) >> (to_int32(b) & 31)
    if op == "instanceof":
        if isinstance(b, JSClass) and isinstance(a, JSObject):
            c = a.klass
            while c is not None:
                if c is b:
                    return True
                c = c.parent
            return False
        if isinstance(b, NativeFunction):  # builtin constructors
            n = b.name
            if n == "Array":
                return isinstance(a, JSArray)
            if n in _TA_SPECS:
                return isinstance(a, TypedArray) and a.name == n
            if n == "ArrayBuffer":
                return isinstance(a, ArrayBuffer)
            if n == "RegExp":
                return isinstance(a, JSRegExp)
        return False
    if op == "in":
        if isinstance(b, JSObject):
            return to_prop(a) in b.props
        if isinstance(b, JSArray):
            idx = to_number(a)
            return isinstance(idx, (int, float)) and \
                0 <= int(idx) < len(b.items)
        return False
    raise JSSyntaxError(f"binary {op}")


# ---------------------------------------------------------------------------
# Builtin namespaces
# ---------------------------------------------------------------------------

def _object_entries(interp, this, args):
    o = args[0]
    if isinstance(o, JSObject):
        return JSArray([JSArray([k, v]) for k, v in o.props.items()])
    if isinstance(o, JSArray):
        return JSArray([JSArray([str(i), v])
                        for i, v in enumerate(o.items)])
    return JSArray([])


def _object_keys(interp, this, args):
    o = args[0]
    if isinstance(o, JSObject):
        return JSArray(list(o.props.keys()))
    if isinstance(o, JSArray):
        return JSArray([str(i) for i in range(len(o.items))])
    return JSArray([])


def _object_values(interp, this, args):
    o = args[0]
    if isinstance(o, JSObject):
        return JSArray(list(o.props.values()))
    if isinstance(o, JSArray):
        return JSArray(list(o.items))
    return JSArray([])


def _object_assign(interp, this, args):
    target = args[0]
    if not isinstance(target, JSObject):
        raise JSError(_make_error("TypeError", "Object.assign target"))
    for src in args[1:]:
        if isinstance(src, JSObject):
            target.props.update(src.props)
    return target


def _array_from(interp, this, args):
    src = args[0]
    items = interp._iterate(src)
    if len(args) > 1 and args[1] is not UNDEFINED:
        items = [interp.call(args[1], UNDEFINED, [v, i])
                 for i, v in enumerate(items)]
    return JSArray(items)


def _promise_all(interp, this, args):
    arr = args[0]
    if not isinstance(arr, JSArray):
        raise JSError(_make_error("TypeError", "Promise.all expects array"))
    out = []
    for v in arr.items:
        while isinstance(v, JSPromiseValue):
            v = v.value
        out.append(v)
    return JSPromiseValue(JSArray(out))


def _parse_int(interp, this, args):
    s = js_str(args[0]).strip() if args else ""
    radix = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not UNDEFINED else 10
    neg = s.startswith("-")
    if s[:1] in "+-":
        s = s[1:]
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:radix]
    out = 0
    seen = False
    for ch in s.lower():
        d = digits.find(ch)
        if d < 0:
            break
        out = out * radix + d
        seen = True
    if not seen:
        return float("nan")
    return -out if neg else out


def _parse_float(interp, this, args):
    s = js_str(args[0]).strip() if args else ""
    m = _regex.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    if not m:
        return float("nan")
    return float(m.group(0))


def js_typeof(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (JSFunction, NativeFunction, BoundMethod, JSClass)):
        return "function"
    return "object"


# ---------------------------------------------------------------------------
# Array methods
# ---------------------------------------------------------------------------

def _arr_push(interp, this, args):
    this.items.extend(args)
    return len(this.items)


def _arr_pop(interp, this, args):
    return this.items.pop() if this.items else UNDEFINED


def _arr_shift(interp, this, args):
    return this.items.pop(0) if this.items else UNDEFINED


def _arr_unshift(interp, this, args):
    this.items[0:0] = args
    return len(this.items)


def _arr_map(interp, this, args):
    fn = args[0]
    return JSArray([interp.call(fn, UNDEFINED, [v, i, this])
                    for i, v in enumerate(this.items)])


def _arr_foreach(interp, this, args):
    fn = args[0]
    for i, v in enumerate(list(this.items)):
        interp.call(fn, UNDEFINED, [v, i, this])
    return UNDEFINED


def _arr_filter(interp, this, args):
    fn = args[0]
    return JSArray([v for i, v in enumerate(this.items)
                    if truthy(interp.call(fn, UNDEFINED, [v, i, this]))])


def _arr_reduce(interp, this, args):
    fn = args[0]
    items = this.items
    if len(args) > 1:
        acc, start = args[1], 0
    else:
        if not items:
            raise JSError(_make_error("TypeError",
                                      "reduce of empty array"))
        acc, start = items[0], 1
    for i in range(start, len(items)):
        acc = interp.call(fn, UNDEFINED, [acc, items[i], i, this])
    return acc


def _arr_sort(interp, this, args):
    if args and args[0] is not UNDEFINED:
        fn = args[0]

        def cmp(a, b):
            r = to_number(interp.call(fn, UNDEFINED, [a, b]))
            if isinstance(r, float) and math.isnan(r):
                return 0
            return -1 if r < 0 else (1 if r > 0 else 0)
        this.items.sort(key=cmp_to_key(cmp))
    else:
        this.items.sort(key=js_str)
    return this


def _arr_slice(interp, this, args):
    n = len(this.items)
    a = int(to_number(args[0])) if args and args[0] is not UNDEFINED else 0
    b = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not UNDEFINED else n
    a = max(0, a + n) if a < 0 else min(a, n)
    b = max(0, b + n) if b < 0 else min(b, n)
    return JSArray(this.items[a:max(a, b)])


def _arr_splice(interp, this, args):
    n = len(this.items)
    a = int(to_number(args[0])) if args else 0
    a = max(0, a + n) if a < 0 else min(a, n)
    dc = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not UNDEFINED else n - a
    removed = this.items[a:a + dc]
    this.items[a:a + dc] = list(args[2:])
    return JSArray(removed)


def _arr_concat(interp, this, args):
    out = list(this.items)
    for a in args:
        if isinstance(a, JSArray):
            out.extend(a.items)
        else:
            out.append(a)
    return JSArray(out)


def _arr_includes(interp, this, args):
    x = args[0] if args else UNDEFINED
    for v in this.items:
        if strict_eq(v, x) or (isinstance(v, float) and math.isnan(v) and
                               isinstance(x, float) and math.isnan(x)):
            return True
    return False


def _arr_indexof(interp, this, args):
    x = args[0] if args else UNDEFINED
    for i, v in enumerate(this.items):
        if strict_eq(v, x):
            return i
    return -1


def _arr_join(interp, this, args):
    sep = js_str(args[0]) if args and args[0] is not UNDEFINED else ","
    return sep.join("" if (v is None or v is UNDEFINED) else js_str(v)
                    for v in this.items)


def _arr_reverse(interp, this, args):
    this.items.reverse()
    return this


def _arr_some(interp, this, args):
    fn = args[0]
    return any(truthy(interp.call(fn, UNDEFINED, [v, i, this]))
               for i, v in enumerate(this.items))


def _arr_every(interp, this, args):
    fn = args[0]
    return all(truthy(interp.call(fn, UNDEFINED, [v, i, this]))
               for i, v in enumerate(this.items))


def _arr_find(interp, this, args):
    fn = args[0]
    for i, v in enumerate(this.items):
        if truthy(interp.call(fn, UNDEFINED, [v, i, this])):
            return v
    return UNDEFINED


def _arr_findindex(interp, this, args):
    fn = args[0]
    for i, v in enumerate(this.items):
        if truthy(interp.call(fn, UNDEFINED, [v, i, this])):
            return i
    return -1


def _arr_flat(interp, this, args):
    out = []
    for v in this.items:
        if isinstance(v, JSArray):
            out.extend(v.items)
        else:
            out.append(v)
    return JSArray(out)


def _arr_fill(interp, this, args):
    v = args[0] if args else UNDEFINED
    for i in range(len(this.items)):
        this.items[i] = v
    return this


_ARRAY_METHODS = {
    "push": _arr_push, "pop": _arr_pop, "shift": _arr_shift,
    "unshift": _arr_unshift, "map": _arr_map, "forEach": _arr_foreach,
    "filter": _arr_filter, "reduce": _arr_reduce, "sort": _arr_sort,
    "slice": _arr_slice, "splice": _arr_splice, "concat": _arr_concat,
    "includes": _arr_includes, "indexOf": _arr_indexof, "join": _arr_join,
    "reverse": _arr_reverse, "some": _arr_some, "every": _arr_every,
    "find": _arr_find, "findIndex": _arr_findindex, "flat": _arr_flat,
    "fill": _arr_fill,
}


# ---------------------------------------------------------------------------
# String methods
# ---------------------------------------------------------------------------

def _match_to_js(m) -> JSArray:
    arr = JSArray([m.group(0)] +
                  [g if g is not None else UNDEFINED
                   for g in m.groups()])
    return arr


def _str_split(interp, this, args):
    if not args or args[0] is UNDEFINED:
        return JSArray([this])
    sep = args[0]
    if isinstance(sep, JSRegExp):
        return JSArray(sep.pat.split(this))
    sep = js_str(sep)
    if sep == "":
        return JSArray(list(this))
    return JSArray(this.split(sep))


def _str_replace(interp, this, args):
    pat, repl = args[0], args[1]
    def do_one(m):
        if isinstance(repl, (JSFunction, NativeFunction, BoundMethod)):
            return js_str(interp.call(repl, UNDEFINED, [m.group(0)]))
        return js_str(repl).replace("$&", m.group(0))
    if isinstance(pat, JSRegExp):
        count = 0 if pat.global_ else 1
        return pat.pat.sub(do_one, this, count=count)
    p = js_str(pat)
    if isinstance(repl, (JSFunction, NativeFunction, BoundMethod)):
        idx = this.find(p)
        if idx < 0:
            return this
        rep = js_str(interp.call(repl, UNDEFINED, [p]))
        return this[:idx] + rep + this[idx + len(p):]
    return this.replace(p, js_str(repl), 1)


def _str_replaceall(interp, this, args):
    pat, repl = args[0], args[1]
    if isinstance(pat, JSRegExp):
        return _str_replace(interp, this, args)
    return this.replace(js_str(pat), js_str(repl))


def _str_matchall(interp, this, args):
    pat = args[0]
    if not isinstance(pat, JSRegExp):
        pat = JSRegExp(js_str(pat), "g")
    if not pat.global_:
        raise JSError(_make_error(
            "TypeError", "matchAll requires the g flag"))
    return JSArray([_match_to_js(m) for m in pat.pat.finditer(this)])


def _str_match(interp, this, args):
    pat = args[0]
    if not isinstance(pat, JSRegExp):
        pat = JSRegExp(js_str(pat), "")
    if pat.global_:
        out = [m.group(0) for m in pat.pat.finditer(this)]
        return JSArray(out) if out else None
    m = pat.pat.search(this)
    return _match_to_js(m) if m else None


def _str_slice(interp, this, args):
    n = len(this)
    a = int(to_number(args[0])) if args and args[0] is not UNDEFINED else 0
    b = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not UNDEFINED else n
    a = max(0, a + n) if a < 0 else min(a, n)
    b = max(0, b + n) if b < 0 else min(b, n)
    return this[a:max(a, b)]


def _str_substring(interp, this, args):
    n = len(this)
    a = int(to_number(args[0])) if args and args[0] is not UNDEFINED else 0
    b = int(to_number(args[1])) if len(args) > 1 and \
        args[1] is not UNDEFINED else n
    a, b = max(0, min(a, n)), max(0, min(b, n))
    if a > b:
        a, b = b, a
    return this[a:b]


def _str_charcodeat(interp, this, args):
    i = int(to_number(args[0])) if args else 0
    if 0 <= i < len(this):
        return ord(this[i])
    return float("nan")


def _str_codepointat(interp, this, args):
    i = int(to_number(args[0])) if args else 0
    if 0 <= i < len(this):
        return ord(this[i])
    return UNDEFINED


def _str_padstart(interp, this, args):
    width = int(to_number(args[0])) if args else 0
    fill = js_str(args[1]) if len(args) > 1 and args[1] is not UNDEFINED \
        else " "
    out = this
    while len(out) < width and fill:
        out = fill[:max(0, width - len(out))] + out
    return out


def _str_padend(interp, this, args):
    width = int(to_number(args[0])) if args else 0
    fill = js_str(args[1]) if len(args) > 1 and args[1] is not UNDEFINED \
        else " "
    out = this
    while len(out) < width and fill:
        out = out + fill[:max(0, width - len(out))]
    return out


_STRING_METHODS = {
    "toLowerCase": lambda i, t, a: t.lower(),
    "toUpperCase": lambda i, t, a: t.upper(),
    "normalize": lambda i, t, a: unicodedata.normalize(
        js_str(a[0]) if a else "NFC", t),
    "trim": lambda i, t, a: t.strip(),
    "trimStart": lambda i, t, a: t.lstrip(),
    "trimEnd": lambda i, t, a: t.rstrip(),
    "split": _str_split,
    "replace": _str_replace,
    "replaceAll": _str_replaceall,
    "matchAll": _str_matchall,
    "match": _str_match,
    "slice": _str_slice,
    "substring": _str_substring,
    "indexOf": lambda i, t, a: t.find(js_str(a[0])) if a else -1,
    "lastIndexOf": lambda i, t, a: t.rfind(js_str(a[0])) if a else -1,
    "includes": lambda i, t, a: js_str(a[0]) in t if a else False,
    "startsWith": lambda i, t, a: t.startswith(js_str(a[0])) if a else False,
    "endsWith": lambda i, t, a: t.endswith(js_str(a[0])) if a else False,
    "charAt": lambda i, t, a: t[int(to_number(a[0]))]
    if a and 0 <= int(to_number(a[0])) < len(t) else "",
    "charCodeAt": _str_charcodeat,
    "codePointAt": _str_codepointat,
    "repeat": lambda i, t, a: t * int(to_number(a[0])) if a else "",
    "concat": lambda i, t, a: t + "".join(js_str(x) for x in a),
    "padStart": _str_padstart,
    "padEnd": _str_padend,
    "at": lambda i, t, a: (t[int(to_number(a[0]))]
                           if -len(t) <= int(to_number(a[0])) < len(t)
                           else UNDEFINED) if a else UNDEFINED,
}


def _num_tofixed(interp, this, args):
    digits = int(to_number(args[0])) if args and args[0] is not UNDEFINED \
        else 0
    return f"{to_number(this):.{digits}f}"


_NUMBER_METHODS = {
    "toFixed": _num_tofixed,
    "toString": lambda i, t, a: js_str(t),
}


def _regex_test(interp, this, args):
    s = js_str(args[0]) if args else ""
    return this.pat.search(s) is not None


def _regex_exec(interp, this, args):
    s = js_str(args[0]) if args else ""
    m = this.pat.search(s)
    return _match_to_js(m) if m else None


_REGEX_METHODS = {
    "test": _regex_test,
    "exec": _regex_exec,
}


# ---------------------------------------------------------------------------
# Host <-> JS conversion
# ---------------------------------------------------------------------------

def host_to_js(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (JSObject, JSArray, TypedArray, ArrayBuffer, JSFunction,
                      NativeFunction, BoundMethod, JSClass, JSRegExp,
                      JSUndefinedType, JSPromiseValue)):
        return v
    if isinstance(v, dict):
        return JSObject({str(k): host_to_js(x) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return JSArray([host_to_js(x) for x in v])
    if isinstance(v, (bytes, bytearray)):
        return ArrayBuffer(bytearray(v))
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        if a.dtype == np.float32:
            buf = bytearray(a.tobytes())
            return TypedArray(memoryview(buf).cast("f"), "f", "Float32Array")
        if a.dtype == np.uint8:
            buf = bytearray(a.tobytes())
            return TypedArray(memoryview(buf).cast("B"), "B", "Uint8Array")
        return JSArray([host_to_js(x) for x in a.tolist()])
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if callable(v):
        def shim(interp, this, args):
            return host_to_js(v(*[js_to_host(a) for a in args]))
        return NativeFunction(getattr(v, "__name__", "hostfn"), shim)
    raise TypeError(f"cannot convert host value of type {type(v).__name__}")


def js_to_host(v):
    if v is UNDEFINED:
        return None
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, JSArray):
        return [js_to_host(x) for x in v.items]
    if isinstance(v, JSObject):
        return {k: js_to_host(x) for k, x in v.props.items()}
    if isinstance(v, TypedArray):
        dt = {"f": np.float32, "d": np.float64, "B": np.uint8, "b": np.int8,
              "H": np.uint16, "h": np.int16, "I": np.uint32,
              "i": np.int32}[v.fmt]
        return np.frombuffer(v.mv.tobytes(), dtype=dt).copy()
    if isinstance(v, ArrayBuffer):
        return bytes(v.data)
    if isinstance(v, JSPromiseValue):
        return js_to_host(v.value)
    return v


# ---------------------------------------------------------------------------
# fetch shim + module loading
# ---------------------------------------------------------------------------

def make_fetch(base_dir: Path) -> NativeFunction:
    """A synchronous `fetch` that resolves URLs as paths under base_dir."""
    base = Path(base_dir)

    def fetch(interp, this, args):
        url = js_str(args[0])
        rel = url.split("://", 1)[-1].lstrip("/") if "://" in url else url
        path = (base / rel).resolve()

        def json_m(i2, t2, a2):
            return JSPromiseValue(host_to_js(json.loads(path.read_text())))

        def buf_m(i2, t2, a2):
            return JSPromiseValue(ArrayBuffer(bytearray(path.read_bytes())))

        def text_m(i2, t2, a2):
            return JSPromiseValue(path.read_text())

        resp = JSObject({
            "ok": path.exists(),
            "status": 200 if path.exists() else 404,
            "url": url,
            "json": NativeFunction("json", json_m),
            "arrayBuffer": NativeFunction("arrayBuffer", buf_m),
            "text": NativeFunction("text", text_m),
        })
        return JSPromiseValue(resp)

    return NativeFunction("fetch", fetch)


def run_source(src: str, extra_globals: dict | None = None) -> Interpreter:
    interp = Interpreter(extra_globals)
    interp.run(src)
    return interp


def load_module(path, extra_globals: dict | None = None,
                fetch_base: Path | None = None):
    """Execute a CommonJS-style module file; returns (interp, exports)."""
    src = Path(path).read_text()
    module = JSObject({"exports": JSObject()})
    g = {"module": module}
    if fetch_base is not None:
        g["fetch"] = make_fetch(fetch_base)
    if extra_globals:
        g.update(extra_globals)
    interp = run_source(src, g)
    return interp, module.props["exports"]
