"""Recursive-descent / Pratt parser for the jsvm JavaScript subset.

AST nodes are plain tuples `(kind, ...)` — cheap to allocate and to dispatch
on in the evaluator. Unsupported syntax raises JSSyntaxError at parse time so
a construct outside the subset can never silently misexecute.

A verbatim copy of kjarni_tpu/export/jsvm/parser.py (the port imports nothing
of the JAX package); only this paragraph differs.
"""

from __future__ import annotations

from .lexer import JSSyntaxError, Token, tokenize

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "**=", "&=", "|=", "^=",
               "<<=", ">>=", "&&=", "||=", "??="}

# binary precedence (higher binds tighter); && / || / ?? handled separately
_BIN_PREC = {
    "|": 6, "^": 7, "&": 8,
    "==": 9, "!=": 9, "===": 9, "!==": 9,
    "<": 10, ">": 10, "<=": 10, ">=": 10, "instanceof": 10, "in": 10,
    "<<": 11, ">>": 11, ">>>": 11,
    "+": 12, "-": 12,
    "*": 13, "/": 13, "%": 13,
    "**": 14,
}


class Parser:
    def __init__(self, src: str):
        self.toks: list[Token] = tokenize(src)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        t = self.peek(k)
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value=None) -> Token | None:
        if self.at(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise JSSyntaxError(
                f"line {t.line}: expected {value or kind}, got "
                f"{t.kind} {t.value!r}")
        return t

    def expect_semi(self):
        if self.eat("punct", ";"):
            return
        t = self.peek()
        if t.kind == "eof" or (t.kind == "punct" and t.value == "}"):
            return
        if t.nl_before:  # ASI
            return
        raise JSSyntaxError(f"line {t.line}: expected ';' before {t.value!r}")

    # -- program ------------------------------------------------------------

    def parse_program(self) -> list:
        stmts = []
        while not self.at("eof"):
            stmts.append(self.parse_statement())
        return stmts

    # -- statements ---------------------------------------------------------

    def parse_statement(self):
        t = self.peek()
        if t.kind == "punct" and t.value == "{":
            return self.parse_block()
        if t.kind == "punct" and t.value == ";":
            self.next()
            return ("Empty",)
        if t.kind == "kw":
            v = t.value
            if v in ("let", "const", "var"):
                d = self.parse_var_decl()
                self.expect_semi()
                return d
            if v == "function":
                return self.parse_function_decl(is_async=False)
            if v == "async" and self.at("kw", "function", 1):
                self.next()
                return self.parse_function_decl(is_async=True)
            if v == "class":
                return self.parse_class()
            if v == "if":
                return self.parse_if()
            if v == "for":
                return self.parse_for()
            if v == "while":
                self.next()
                self.expect("punct", "(")
                test = self.parse_expression()
                self.expect("punct", ")")
                return ("While", test, self.parse_statement())
            if v == "do":
                self.next()
                body = self.parse_statement()
                self.expect("kw", "while")
                self.expect("punct", "(")
                test = self.parse_expression()
                self.expect("punct", ")")
                self.expect_semi()
                return ("DoWhile", body, test)
            if v == "return":
                self.next()
                nt = self.peek()
                if (nt.kind == "punct" and nt.value in (";", "}")) \
                        or nt.kind == "eof" or nt.nl_before:
                    self.expect_semi()
                    return ("Return", None)
                e = self.parse_expression()
                self.expect_semi()
                return ("Return", e)
            if v == "break":
                self.next()
                self.expect_semi()
                return ("Break",)
            if v == "continue":
                self.next()
                self.expect_semi()
                return ("Continue",)
            if v == "throw":
                self.next()
                e = self.parse_expression()
                self.expect_semi()
                return ("Throw", e)
            if v == "try":
                return self.parse_try()
            if v in ("switch", "yield", "delete"):
                raise JSSyntaxError(f"line {t.line}: '{v}' unsupported by jsvm")
        e = self.parse_expression()
        self.expect_semi()
        return ("ExprStmt", e)

    def parse_block(self):
        self.expect("punct", "{")
        stmts = []
        while not self.eat("punct", "}"):
            if self.at("eof"):
                raise JSSyntaxError("unexpected EOF in block")
            stmts.append(self.parse_statement())
        return ("Block", stmts)

    def parse_var_decl(self):
        kind = self.next().value
        decls = []
        while True:
            pat = self.parse_binding_pattern()
            init = None
            if self.eat("punct", "="):
                init = self.parse_assignment()
            decls.append((pat, init))
            if not self.eat("punct", ","):
                break
        return ("VarDecl", kind, decls)

    def parse_binding_pattern(self, allow_default: bool = False):
        # allow_default: in params and destructuring elements, a trailing
        # `= expr` is a default value. NOT allowed at a var-decl top level,
        # where `=` is the initializer (parse_var_decl consumes it).
        pat = self._parse_binding_base()
        if allow_default and self.eat("punct", "="):
            pat = ("DefaultPat", pat, self.parse_assignment())
        return pat

    def _parse_binding_base(self):
        t = self.peek()
        if t.kind == "ident" or (t.kind == "kw" and t.value in
                                 ("async", "get", "set", "of", "static")):
            self.next()
            return ("IdPat", t.value)
        if t.kind == "punct" and t.value == "[":
            self.next()
            elems = []
            while not self.eat("punct", "]"):
                if self.at("punct", ","):    # elision hole: [a,,b]
                    self.next()
                    elems.append(None)
                    continue
                if self.eat("punct", "..."):
                    elems.append(("RestPat", self.parse_binding_pattern()))
                else:
                    elems.append(self.parse_binding_pattern(True))
                if not self.at("punct", "]"):
                    self.expect("punct", ",")
            return ("ArrayPat", elems)
        if t.kind == "punct" and t.value == "{":
            self.next()
            props = []
            while not self.eat("punct", "}"):
                key = self.next()
                if key.kind not in ("ident", "str", "kw"):
                    raise JSSyntaxError(
                        f"line {key.line}: bad destructuring key")
                if self.eat("punct", ":"):
                    props.append((key.value,
                                  self.parse_binding_pattern(True)))
                else:
                    pat = ("IdPat", key.value)
                    if self.eat("punct", "="):
                        pat = ("DefaultPat", pat, self.parse_assignment())
                    props.append((key.value, pat))
                if not self.at("punct", "}"):
                    self.expect("punct", ",")
            return ("ObjectPat", props)
        raise JSSyntaxError(f"line {t.line}: bad binding target {t.value!r}")

    def parse_function_decl(self, is_async: bool):
        self.expect("kw", "function")
        name = self.expect("ident").value
        params = self.parse_params()
        body = self.parse_block()
        return ("FuncDecl", name, params, body, is_async)

    def parse_params(self) -> list:
        self.expect("punct", "(")
        params = []
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                params.append(("RestPat", self.parse_binding_pattern()))
            else:
                params.append(self.parse_binding_pattern(True))
            if not self.at("punct", ")"):
                self.expect("punct", ",")
        return params

    def parse_class(self):
        self.expect("kw", "class")
        name = self.expect("ident").value
        superclass = None
        if self.eat("kw", "extends"):
            superclass = self.parse_unary_chain()
        self.expect("punct", "{")
        members = []
        while not self.eat("punct", "}"):
            if self.eat("punct", ";"):
                continue
            is_static = bool(self.eat("kw", "static"))
            is_async = False
            if self.at("kw", "async") and not self.at("punct", "(", 1):
                self.next()
                is_async = True
            mt = self.next()
            if mt.kind not in ("ident", "kw", "str"):
                raise JSSyntaxError(f"line {mt.line}: bad class member")
            mname = mt.value
            params = self.parse_params()
            body = self.parse_block()
            members.append((mname, params, body, is_static, is_async))
        return ("ClassDecl", name, superclass, members)

    def parse_if(self):
        self.expect("kw", "if")
        self.expect("punct", "(")
        test = self.parse_expression()
        self.expect("punct", ")")
        cons = self.parse_statement()
        alt = None
        if self.eat("kw", "else"):
            alt = self.parse_statement()
        return ("If", test, cons, alt)

    def parse_for(self):
        self.expect("kw", "for")
        self.expect("punct", "(")
        init = None
        if not self.at("punct", ";"):
            if self.at("kw") and self.peek().value in ("let", "const", "var"):
                kind = self.peek().value
                save = self.i
                decl = self.parse_var_decl()
                if self.at("kw", "of") or self.at("kw", "in"):
                    is_in = self.next().value == "in"
                    if len(decl[2]) != 1 or decl[2][0][1] is not None:
                        raise JSSyntaxError("bad for-of/in declaration")
                    iterable = self.parse_expression()
                    self.expect("punct", ")")
                    body = self.parse_statement()
                    node = "ForIn" if is_in else "ForOf"
                    return (node, kind, decl[2][0][0], iterable, body)
                del save
                init = decl
            else:
                init = ("ExprStmt", self.parse_expression())
        self.expect("punct", ";")
        test = None if self.at("punct", ";") else self.parse_expression()
        self.expect("punct", ";")
        update = None if self.at("punct", ")") else self.parse_expression()
        self.expect("punct", ")")
        body = self.parse_statement()
        return ("For", init, test, update, body)

    def parse_try(self):
        self.expect("kw", "try")
        block = self.parse_block()
        param = None
        handler = None
        final = None
        if self.eat("kw", "catch"):
            if self.eat("punct", "("):
                param = self.parse_binding_pattern()
                self.expect("punct", ")")
            handler = self.parse_block()
        if self.eat("kw", "finally"):
            final = self.parse_block()
        if handler is None and final is None:
            raise JSSyntaxError("try without catch/finally")
        return ("Try", block, param, handler, final)

    # -- expressions --------------------------------------------------------

    def parse_expression(self):
        e = self.parse_assignment()
        if self.at("punct", ","):
            exprs = [e]
            while self.eat("punct", ","):
                exprs.append(self.parse_assignment())
            return ("Seq", exprs)
        return e

    def parse_assignment(self):
        arrow = self.try_parse_arrow()
        if arrow is not None:
            return arrow
        left = self.parse_conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in _ASSIGN_OPS:
            self.next()
            if left[0] not in ("Ident", "Member", "Index"):
                raise JSSyntaxError(f"line {t.line}: invalid assignment target")
            right = self.parse_assignment()
            return ("Assign", t.value, left, right)
        return left

    def try_parse_arrow(self):
        """Detect `x => ...` / `(a, b) => ...` / `async x => ...`."""
        is_async = False
        k = 0
        if self.at("kw", "async") and not self.peek(1).nl_before and (
                self.at("ident", None, 1) or self.at("punct", "(", 1)):
            # could still be a call `async(...)`; only treat as arrow if a
            # `=>` follows the parameter list
            is_async = True
            k = 1
        if self.at("ident", None, k) and self.at("punct", "=>", k + 1):
            if is_async:
                self.next()
            name = self.next().value
            self.expect("punct", "=>")
            return self.finish_arrow([("IdPat", name)], is_async)
        if self.at("punct", "(", k):
            j = self.i + k
            depth = 0
            while j < len(self.toks):
                t = self.toks[j]
                if t.kind == "punct" and t.value in ("(", "[", "{"):
                    depth += 1
                elif t.kind == "punct" and t.value in (")", "]", "}"):
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            nxt = self.toks[j + 1] if j + 1 < len(self.toks) else None
            if nxt is not None and nxt.kind == "punct" and nxt.value == "=>":
                if is_async:
                    self.next()
                params = self.parse_params()
                self.expect("punct", "=>")
                return self.finish_arrow(params, is_async)
        return None

    def finish_arrow(self, params, is_async):
        if self.at("punct", "{"):
            body = self.parse_block()
            return ("Arrow", params, body, False, is_async)
        return ("Arrow", params, self.parse_assignment(), True, is_async)

    def parse_conditional(self):
        test = self.parse_nullish()
        if self.eat("punct", "?"):
            cons = self.parse_assignment()
            self.expect("punct", ":")
            alt = self.parse_assignment()
            return ("Cond", test, cons, alt)
        return test

    def parse_nullish(self):
        left = self.parse_or()
        while self.at("punct", "??"):
            self.next()
            left = ("Logic", "??", left, self.parse_or())
        return left

    def parse_or(self):
        left = self.parse_and()
        while self.at("punct", "||"):
            self.next()
            left = ("Logic", "||", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_binary(6)
        while self.at("punct", "&&"):
            self.next()
            left = ("Logic", "&&", left, self.parse_binary(6))
        return left

    def parse_binary(self, min_prec: int):
        left = self.parse_unary()
        while True:
            t = self.peek()
            op = t.value if t.kind == "punct" else (
                t.value if t.kind == "kw" and t.value in ("instanceof", "in")
                else None)
            prec = _BIN_PREC.get(op)
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self.parse_binary(prec + 1)
            left = ("Bin", op, left, right)

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "-", "+", "~"):
            self.next()
            return ("Unary", t.value, self.parse_unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            target = self.parse_unary()
            return ("Update", t.value, True, target)
        if t.kind == "kw" and t.value in ("typeof", "void"):
            self.next()
            return ("Unary", t.value, self.parse_unary())
        if t.kind == "kw" and t.value == "await":
            self.next()
            return ("Await", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_unary_chain()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") and not t.nl_before:
            self.next()
            return ("Update", t.value, False, e)
        return e

    def parse_unary_chain(self):
        if self.at("kw", "new"):
            self.next()
            callee = self.parse_member_only(self.parse_primary())
            args = []
            if self.at("punct", "("):
                args = self.parse_args()
            return self.parse_call_tail(("New", callee, args))
        return self.parse_call_tail(self.parse_primary())

    def parse_member_only(self, e):
        """Member accesses only (no calls) — for `new a.b.C(...)`."""
        while True:
            if self.eat("punct", "."):
                name = self.next()
                if name.kind not in ("ident", "kw"):
                    raise JSSyntaxError(f"line {name.line}: bad member name")
                e = ("Member", e, name.value)
            elif self.at("punct", "["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                e = ("Index", e, idx)
            else:
                return e

    def parse_call_tail(self, e):
        while True:
            if self.eat("punct", "."):
                name = self.next()
                if name.kind not in ("ident", "kw"):
                    raise JSSyntaxError(f"line {name.line}: bad member name")
                e = ("Member", e, name.value)
            elif self.at("punct", "["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                e = ("Index", e, idx)
            elif self.at("punct", "("):
                e = ("Call", e, self.parse_args())
            elif self.at("punct", "?."):
                raise JSSyntaxError("optional chaining unsupported by jsvm")
            else:
                return e

    def parse_args(self) -> list:
        self.expect("punct", "(")
        args = []
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                args.append(("Spread", self.parse_assignment()))
            else:
                args.append(self.parse_assignment())
            if not self.at("punct", ")"):
                self.expect("punct", ",")
        return args

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return ("Num", t.value)
        if t.kind == "str":
            return ("Str", t.value)
        if t.kind == "regex":
            return ("Regex", t.value[0], t.value[1])
        if t.kind == "ident":
            return ("Ident", t.value)
        if t.kind == "kw":
            v = t.value
            if v == "true":
                return ("Bool", True)
            if v == "false":
                return ("Bool", False)
            if v == "null":
                return ("Null",)
            if v == "undefined":
                return ("Undef",)
            if v == "this":
                return ("This",)
            if v == "function":
                name = None
                if self.at("ident"):
                    name = self.next().value
                params = self.parse_params()
                body = self.parse_block()
                return ("Func", name, params, body, False)
            if v == "async" and self.at("kw", "function"):
                self.next()
                name = None
                if self.at("ident"):
                    name = self.next().value
                params = self.parse_params()
                body = self.parse_block()
                return ("Func", name, params, body, True)
            if v == "class":
                self.i -= 1
                return self.parse_class()
            if v in ("of", "get", "set", "static", "async"):
                return ("Ident", v)   # contextual keywords in expr position
            raise JSSyntaxError(f"line {t.line}: unexpected keyword '{v}'")
        if t.kind == "punct":
            if t.value == "(":
                e = self.parse_expression()
                self.expect("punct", ")")
                return e
            if t.value == "[":
                elems = []
                while not self.eat("punct", "]"):
                    if self.eat("punct", "..."):
                        elems.append(("Spread", self.parse_assignment()))
                    else:
                        elems.append(self.parse_assignment())
                    if not self.at("punct", "]"):
                        self.expect("punct", ",")
                return ("Array", elems)
            if t.value == "{":
                props = []
                while True:
                    if self.eat("punct", "}"):
                        break
                    key = self.next()
                    if key.kind == "punct" and key.value == "[":
                        raise JSSyntaxError(
                            f"line {key.line}: computed keys unsupported")
                    if key.kind not in ("ident", "str", "num", "kw"):
                        raise JSSyntaxError(
                            f"line {key.line}: bad object key {key.value!r}")
                    kname = key.value if not isinstance(key.value, (int, float)) \
                        else _num_key(key.value)
                    if self.eat("punct", ":"):
                        props.append((kname, self.parse_assignment()))
                    elif self.at("punct", "("):
                        params = self.parse_params()
                        body = self.parse_block()
                        props.append((kname, ("Func", kname, params, body,
                                              False)))
                    else:
                        props.append((kname, ("Ident", key.value)))
                    if not self.at("punct", "}"):
                        self.expect("punct", ",")
                return ("Object", props)
        raise JSSyntaxError(f"line {t.line}: unexpected token {t.value!r}")


def _num_key(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def parse(src: str) -> list:
    return Parser(src).parse_program()
