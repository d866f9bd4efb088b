"""Dy2Static: AST-level rewrite of Python control flow to traceable form
(port of ``paddle_tpu/jit/dy2static.py``; the passes are the JAX
package's as they are).

Converts a dygraph-style Python function into an equivalent function
whose ``if``/``while``/``for range()``/``break``/``continue``/``return``
statements are rewritten into calls to the runtime dispatch helpers in
``paddle_tpu_torch.jit.convert_ops``. Eagerly the converted function
behaves as the original; while ``torch.export`` traces it,
tensor-dependent conditions lower to ``torch.cond`` /
``torch._higher_order_ops.while_loop``, so the exported program keeps
data-dependent control flow (the reference's AST transformer suite,
python/paddle/fluid/dygraph/dygraph_to_static/).

Pipeline (per function, nested defs untouched):
  1. for-range  -> while            (iterator var threaded explicitly)
  2. break/continue -> flag vars + tail guards; loop-else lifted
  3. return     -> flag var + value var + tail guards
  4. and/or/not -> short-circuit-preserving convert_logical_* calls
  5. assert     -> convert_assert
  6. if/while   -> branch/body functions + convert_ifelse/convert_while

Known limits (the reference's family): object mutation inside a
tensor-dependent branch runs on both paths while traced; branches must
produce type-compatible values; nested function defs keep Python
control flow.
"""

from __future__ import annotations

import ast
import functools
import inspect
import linecache
import textwrap
from typing import List, Optional, Sequence

# the helpers' global name in a converted function's module (not the JAX
# package's, so a module may hold functions converted by both)
_D2S = "__pt_torch_d2s__"
_FN_PREFIX = "__pt_fn_"


# ---------------------------------------------------------------- ast utils

def _load(name: str) -> ast.Name:
    return ast.Name(id=name, ctx=ast.Load())


def _store(name: str) -> ast.Name:
    return ast.Name(id=name, ctx=ast.Store())


def _d2s(attr: str) -> ast.Attribute:
    return ast.Attribute(value=_load(_D2S), attr=attr, ctx=ast.Load())


def _call(func: ast.expr, args: Sequence[ast.expr]) -> ast.Call:
    return ast.Call(func=func, args=list(args), keywords=[])


def _assign(name: str, value: ast.expr) -> ast.Assign:
    return ast.Assign(targets=[_store(name)], value=value)


def _const(v) -> ast.Constant:
    return ast.Constant(value=v)


def _tuple_load(names: Sequence[str]) -> ast.Tuple:
    return ast.Tuple(elts=[_load(n) for n in names], ctx=ast.Load())


def _tuple_store(names: Sequence[str]) -> ast.Tuple:
    return ast.Tuple(elts=[_store(n) for n in names], ctx=ast.Store())


def _not(e: ast.expr) -> ast.UnaryOp:
    return ast.UnaryOp(op=ast.Not(), operand=e)


def _and(a: ast.expr, b: ast.expr) -> ast.BoolOp:
    return ast.BoolOp(op=ast.And(), values=[a, b])


def _arglist(names: Sequence[str]) -> ast.arguments:
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
        defaults=[])


def _undef_preamble(name: str) -> ast.Try:
    """try: name / except NameError: name = UNDEF  — makes a possibly
    unbound local readable as the UNDEF sentinel before branch capture."""
    return ast.Try(
        body=[ast.Expr(value=_load(name))],
        handlers=[ast.ExceptHandler(
            type=_load("NameError"), name=None,
            body=[_assign(name, _d2s("UNDEF"))])],
        orelse=[], finalbody=[])


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)
_COMP_NODES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


class _AssignedNames(ast.NodeVisitor):
    """Ordered set of names bound in a statement list, within the current
    function scope (no descent into nested defs/lambdas/comprehensions)."""

    def __init__(self):
        self.names: List[str] = []
        self._seen = set()

    def _add(self, n: str):
        if n not in self._seen:
            self._seen.add(n)
            self.names.append(n)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            self._add(node.id)

    def visit_FunctionDef(self, node):
        if not node.name.startswith(_FN_PREFIX):
            self._add(node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._add(node.name)

    def visit_Lambda(self, node):
        pass

    def visit_ListComp(self, node):
        pass

    visit_SetComp = visit_DictComp = visit_GeneratorExp = visit_ListComp


def _assigned_names(stmts: Sequence[ast.stmt]) -> List[str]:
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


def _contains_exit(node, kinds, stop_at_loops: bool) -> bool:
    """Does `node` contain a break/continue/return belonging to the
    current construct? Never descends into nested function scopes;
    optionally stops at nested loops (for break/continue ownership)."""
    found = [False]

    class V(ast.NodeVisitor):
        def visit_Break(self, n):
            if "break" in kinds:
                found[0] = True

        def visit_Continue(self, n):
            if "continue" in kinds:
                found[0] = True

        def visit_Return(self, n):
            if "return" in kinds:
                found[0] = True

        def visit_FunctionDef(self, n):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef

        def visit_For(self, n):
            if not stop_at_loops:
                self.generic_visit(n)

        visit_While = visit_For

    V().visit(node)
    return found[0]


# ------------------------------------------------------------------ passes

class _Namer:
    def __init__(self):
        self.n = 0

    def fresh(self, base: str) -> str:
        self.n += 1
        return f"{base}_{self.n}"


class _ForRangeToWhile(ast.NodeTransformer):
    """for i in range(...) → explicit-counter while (increment happens
    before the body so continue/break guards cannot skip it)."""

    def __init__(self, namer: _Namer):
        self.namer = namer

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_For(self, node):
        self.generic_visit(node)
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords
                and 1 <= len(it.args) <= 3
                and not any(isinstance(a, ast.Starred) for a in it.args)):
            return node
        if len(it.args) == 1:
            start, stop, step = _const(0), it.args[0], _const(1)
        elif len(it.args) == 2:
            start, stop, step = it.args[0], it.args[1], _const(1)
        else:
            start, stop, step = it.args
        iv = self.namer.fresh("__pt_it")
        sv = self.namer.fresh("__pt_stop")
        pv = self.namer.fresh("__pt_step")
        body = [
            ast.Assign(targets=[node.target], value=_load(iv)),
            _assign(iv, ast.BinOp(left=_load(iv), op=ast.Add(),
                                  right=_load(pv))),
        ] + node.body
        w = ast.While(
            test=_call(_d2s("range_continue"),
                       [_load(iv), _load(sv), _load(pv)]),
            body=body, orelse=node.orelse)
        return [_assign(iv, start), _assign(sv, stop), _assign(pv, step), w]


class _FlagRewriter:
    """Shared machinery: replace exit statements with flag assignments and
    guard the statements that follow them with `if not flag:`."""

    def __init__(self, kinds, stop_at_loops, make_replacement,
                 guard_test_fn, loop_test_hook=None):
        self.kinds = kinds
        self.stop_at_loops = stop_at_loops
        self.make_replacement = make_replacement
        self.guard_test_fn = guard_test_fn
        self.loop_test_hook = loop_test_hook

    def _is_exit(self, st):
        return (isinstance(st, ast.Break) and "break" in self.kinds) or \
            (isinstance(st, ast.Continue) and "continue" in self.kinds) or \
            (isinstance(st, ast.Return) and "return" in self.kinds)

    def rewrite(self, stmts: List[ast.stmt]) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for i, st in enumerate(stmts):
            if self._is_exit(st):
                out.extend(self.make_replacement(st))
                sets = True
            else:
                sets = _contains_exit(st, self.kinds, self.stop_at_loops)
                if sets:
                    self._descend(st)
                out.append(st)
            if sets and i < len(stmts) - 1:
                rest = self.rewrite(list(stmts[i + 1:]))
                out.append(ast.If(test=self.guard_test_fn(),
                                  body=rest, orelse=[]))
                return out
        return out

    def _descend(self, st):
        if isinstance(st, _SCOPE_NODES):
            return
        if isinstance(st, (ast.For, ast.While)):
            if self.stop_at_loops:
                return
            st.body = self.rewrite(st.body)
            if st.orelse:
                st.orelse = self.rewrite(st.orelse)
            if self.loop_test_hook is not None:
                self.loop_test_hook(st)
            return
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub:
                setattr(st, field, self.rewrite(sub))
        for handler in getattr(st, "handlers", []) or []:
            handler.body = self.rewrite(handler.body)


class _BreakContinue(ast.NodeTransformer):
    """break/continue → flags + guards; loop else-clause lifted out."""

    def __init__(self, namer: _Namer):
        self.namer = namer

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def _transform_loop(self, node):
        self.generic_visit(node)
        has_break = any(_contains_exit(s, {"break"}, True)
                        for s in node.body)
        has_cont = any(_contains_exit(s, {"continue"}, True)
                       for s in node.body)
        if not (has_break or has_cont):
            if node.orelse:
                orelse, node.orelse = node.orelse, []
                return [node] + orelse
            return node
        bflag = self.namer.fresh("__pt_brk") if has_break else None
        cflag = self.namer.fresh("__pt_cont") if has_cont else None

        def guard_test():
            flags = [f for f in (bflag, cflag) if f]
            e = _load(flags[0])
            for f in flags[1:]:
                e = ast.BoolOp(op=ast.Or(), values=[e, _load(f)])
            return _not(e)

        def replacement(st):
            if isinstance(st, ast.Break):
                return [_assign(bflag, _const(True))]
            return [_assign(cflag, _const(True))]

        kinds = set()
        if has_break:
            kinds.add("break")
        if has_cont:
            kinds.add("continue")
        rw = _FlagRewriter(kinds, True, replacement, guard_test)
        body = rw.rewrite(node.body)
        if cflag:
            body = [_assign(cflag, _const(False))] + body
        pre: List[ast.stmt] = []
        post: List[ast.stmt] = []
        if bflag:
            pre.append(_assign(bflag, _const(False)))
        if isinstance(node, ast.While):
            if bflag:
                node.test = _and(node.test, _not(_load(bflag)))
            node.body = body
        else:  # Python for kept: guard whole body on the break flag
            node.body = [ast.If(test=_not(_load(bflag)), body=body,
                                orelse=[])] if bflag else body
        if node.orelse:
            orelse, node.orelse = node.orelse, []
            if bflag:
                post.append(ast.If(test=_not(_load(bflag)), body=orelse,
                                   orelse=[]))
            else:
                post.extend(orelse)
        return pre + [node] + post

    visit_While = _transform_loop
    visit_For = _transform_loop


class _ReturnTransform:
    """Nested returns → (__pt_ret_flag, __pt_ret_val) + guards."""

    RFLAG = "__pt_ret_flag"
    RVAL = "__pt_ret_val"

    def apply(self, func: ast.FunctionDef) -> None:
        nested = False
        for st in func.body:
            if not isinstance(st, ast.Return) and \
                    _contains_exit(st, {"return"}, False):
                nested = True
                break
        if not nested:
            return

        def replacement(st: ast.Return):
            val = st.value if st.value is not None else _const(None)
            return [_assign(self.RVAL, val),
                    _assign(self.RFLAG, _const(True))]

        def guard_test():
            return _not(_load(self.RFLAG))

        def loop_hook(loop):
            if isinstance(loop, ast.While):
                loop.test = _and(loop.test, _not(_load(self.RFLAG)))
            else:
                loop.body = [ast.If(test=_not(_load(self.RFLAG)),
                                    body=loop.body, orelse=[])]

        rw = _FlagRewriter({"return"}, False, replacement, guard_test,
                           loop_test_hook=loop_hook)
        body = rw.rewrite(func.body)
        func.body = [
            _assign(self.RFLAG, _const(False)),
            _assign(self.RVAL, _d2s("UNDEF")),
        ] + body + [
            ast.Return(value=_call(_d2s("finalize_ret"),
                                   [_load(self.RVAL)]))
        ]


class _Logical(ast.NodeTransformer):
    """and/or → lazy convert_logical_* calls; not → convert_logical_not."""

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        name = "convert_logical_and" if isinstance(node.op, ast.And) \
            else "convert_logical_or"
        expr = node.values[-1]
        for v in reversed(node.values[:-1]):
            expr = _call(_d2s(name), [
                ast.Lambda(args=_arglist([]), body=v),
                ast.Lambda(args=_arglist([]), body=expr)])
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _call(_d2s("convert_logical_not"), [node.operand])
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test]
        if node.msg is not None:
            args.append(ast.Lambda(args=_arglist([]), body=node.msg))
        return ast.Expr(value=_call(_d2s("convert_assert"), args))


class _ControlFlow(ast.NodeTransformer):
    """if → convert_ifelse, while → convert_while (post-order)."""

    def __init__(self, namer: _Namer):
        self.namer = namer

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_If(self, node):
        self.generic_visit(node)
        names = _assigned_names(node.body + node.orelse)
        fn_t = self.namer.fresh(_FN_PREFIX + "true")
        fn_f = self.namer.fresh(_FN_PREFIX + "false")
        ret = ast.Return(value=_tuple_load(names))
        def_t = ast.FunctionDef(
            name=fn_t, args=_arglist(names),
            body=node.body + [ret], decorator_list=[])
        def_f = ast.FunctionDef(
            name=fn_f, args=_arglist(names),
            body=(node.orelse or []) + [ast.Return(
                value=_tuple_load(names))], decorator_list=[])
        pre = [_undef_preamble(n) for n in names]
        call = _call(_d2s("convert_ifelse"), [
            node.test,
            ast.Lambda(args=_arglist([]), body=_call(_load(fn_t),
                                                     [_load(n)
                                                      for n in names])),
            ast.Lambda(args=_arglist([]), body=_call(_load(fn_f),
                                                     [_load(n)
                                                      for n in names])),
        ])
        if names:
            out = ast.Assign(targets=[_tuple_store(names)], value=call)
        else:
            out = ast.Expr(value=call)
        return [def_t, def_f] + pre + [out]

    def visit_While(self, node):
        self.generic_visit(node)
        names = _assigned_names(node.body)
        fn_c = self.namer.fresh(_FN_PREFIX + "cond")
        fn_b = self.namer.fresh(_FN_PREFIX + "body")
        def_c = ast.FunctionDef(
            name=fn_c, args=_arglist(names),
            body=[ast.Return(value=node.test)], decorator_list=[])
        def_b = ast.FunctionDef(
            name=fn_b, args=_arglist(names),
            body=node.body + [ast.Return(value=_tuple_load(names))],
            decorator_list=[])
        pre = [_undef_preamble(n) for n in names]
        call = _call(_d2s("convert_while"),
                     [_load(fn_c), _load(fn_b), _tuple_load(names)])
        if names:
            out = ast.Assign(targets=[_tuple_store(names)], value=call)
        else:
            out = ast.Expr(value=call)
        return [def_c, def_b] + pre + [out]


# ------------------------------------------------------------------- entry

def _transform_function(func: ast.FunctionDef) -> None:
    namer = _Namer()
    func.body = _apply(_ForRangeToWhile(namer), func.body)
    func.body = _apply(_BreakContinue(namer), func.body)
    _ReturnTransform().apply(func)
    func.body = _apply(_Logical(), func.body)
    func.body = _apply(_ControlFlow(namer), func.body)


def _apply(transformer: ast.NodeTransformer,
           stmts: List[ast.stmt]) -> List[ast.stmt]:
    out: List[ast.stmt] = []
    for st in stmts:
        r = transformer.visit(st)
        if r is None:
            continue
        if isinstance(r, list):
            out.extend(r)
        else:
            out.append(r)
    return out


_counter = [0]


def convert_to_static(fn, *, raise_on_error: bool = False):
    """Rewrite `fn`'s control flow into traceable form. Returns `fn`
    unchanged when the source is unavailable or conversion fails (the
    plain tracer still handles tensor-independent control flow)."""
    if getattr(fn, "__pt_converted__", False) or not callable(fn):
        return fn
    if getattr(fn, "__pt_not_to_static__", False):
        # user opt-out (paddle.jit.not_to_static)
        return fn
    try:
        return _convert(fn)
    except Exception:
        if raise_on_error:
            raise
        return fn


def _convert(fn):
    from . import convert_ops

    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    func = tree.body[0]
    if not isinstance(func, ast.FunctionDef):
        return fn
    func.decorator_list = []
    _transform_function(func)

    freevars = fn.__code__.co_freevars
    if freevars:
        factory = ast.FunctionDef(
            name="__pt_factory__", args=_arglist(list(freevars)),
            body=[func, ast.Return(value=_load(func.name))],
            decorator_list=[])
        mod = ast.Module(body=[factory], type_ignores=[])
    else:
        mod = ast.Module(body=[func], type_ignores=[])
    ast.fix_missing_locations(mod)
    code_str = ast.unparse(mod)

    _counter[0] += 1
    filename = f"<dy2static:{getattr(fn, '__qualname__', fn.__name__)}" \
               f"#{_counter[0]}>"
    linecache.cache[filename] = (
        len(code_str), None, code_str.splitlines(True), filename)
    import types
    # Compile in a scratch namespace to obtain code objects, then build
    # the final function over the ORIGINAL module globals and ORIGINAL
    # closure cells, so later rebinding of captured/global names stays
    # visible exactly as it would be to the unconverted function.
    scratch = {_D2S: convert_ops}
    exec(compile(code_str, filename, "exec"), scratch)
    real_globals = fn.__globals__
    real_globals[_D2S] = convert_ops
    if freevars:
        placeholder = scratch["__pt_factory__"](*[None] * len(freevars))
        code = placeholder.__code__
        cell_by_name = dict(zip(fn.__code__.co_freevars, fn.__closure__))
        closure = tuple(cell_by_name[n] for n in code.co_freevars)
    else:
        code = scratch[func.name].__code__
        closure = None
    new_fn = types.FunctionType(code, real_globals, func.name,
                                fn.__defaults__, closure)
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    new_fn = functools.wraps(fn)(new_fn)
    new_fn.__pt_converted__ = True
    new_fn.__pt_source__ = code_str
    return new_fn


class ProgramTranslator:
    """Global switch for dy2static conversion
    (reference: program_translator.py:759 ProgramTranslator)."""

    _instance = None
    enabled = True

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def enable(cls, flag: bool) -> None:
        cls.enabled = bool(flag)


def enable_to_static(flag: bool) -> None:
    ProgramTranslator.enable(flag)
