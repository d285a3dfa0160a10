"""A stdlib renderer for the subset of Jinja that public chat templates use.

The reference renders HF chat templates with ``jinja2`` (``ChatTemplate``
in dynamo_tpu/tokenizer.py: ``trim_blocks``, ``lstrip_blocks``, the
built-in ``tojson``, a ``raise_exception`` global), which the card's
machine lacks. This module renders the same text for:

  * text, ``{{ expr }}``, ``{% stmt %}`` and ``{# comment #}`` with ``-`` /
    ``+`` whitespace control, ``trim_blocks`` and ``lstrip_blocks`` as
    jinja2's lexer applies them (newlines normalized, one trailing newline
    dropped);
  * ``for`` (tuple targets, an ``if`` filter, ``else``; ``loop.index`` /
    ``index0`` / ``revindex`` / ``revindex0`` / ``first`` / ``last`` /
    ``length`` / ``previtem`` / ``nextitem``; a fresh scope per iteration),
    ``if`` / ``elif`` / ``else``, ``set`` (names, ``ns.attr`` of a
    ``namespace()``, and ``{% set x %}...{% endset %}``);
  * literals (strings, numbers, lists, tuples, dicts, true / false / none),
    ``a if c else b``, ``and`` / ``or`` / ``not``, comparisons, ``in`` /
    ``not in``, ``~``, ``+ - * / // % **``, attribute access, subscripts and
    slices, calls of ``range`` / ``namespace`` / ``dict`` /
    ``raise_exception`` and of the str / dict / list methods in ``METHODS``;
  * the tests ``defined`` / ``undefined`` / ``none`` / ``string`` /
    ``mapping`` / ``iterable`` / ``sequence`` / ``number`` / ``integer`` /
    ``boolean`` / ``true`` / ``false`` (also after ``is not``);
  * the filters in ``FILTERS`` (``trim``, ``tojson`` with jinja2's HTML-safe
    escapes and sorted keys, ``length``, ``default``, ``upper``, ``lower``,
    ``first``, ``last``, ``join`` and a few more).

Undefined names and missing keys behave as jinja2's default ``Undefined``:
they print as "", are false, have length 0, and raise when an attribute or
item of them is read or they take part in arithmetic. Syntax outside the
subset (an unknown tag, filter or test, macros, ``raw``, ...) raises
``TemplateSyntaxError`` when the template is constructed.
"""

from __future__ import annotations

import json
import re
from collections.abc import Mapping
from numbers import Number
from typing import Any, Callable, Optional


class TemplateSyntaxError(ValueError):
    """The template uses syntax outside the supported subset."""


class TemplateError(ValueError):
    """Rendering failed (an undefined value used, raise_exception, ...)."""


class Undefined:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def _fail(self, *_a, **_k):
        raise TemplateError(f"{self.name!r} is undefined")

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    __hash__ = object.__hash__
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __floordiv__ = __mod__ = __pow__ = __neg__ = __pos__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __call__ = __getitem__ = _fail


class Markup(str):
    """What ``tojson`` returns, as jinja2's Markup: ``+`` HTML-escapes a
    plain string on the other side."""

    @staticmethod
    def _escape(s: Any) -> str:
        if isinstance(s, Markup):
            return s
        return (str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
                .replace("'", "&#39;").replace('"', "&#34;"))

    def __add__(self, other):
        if isinstance(other, str):
            return Markup(str.__add__(self, self._escape(other)))
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, str):
            return Markup(str.__add__(self._escape(other), self))
        return NotImplemented


class Namespace:
    def __init__(self, **attrs: Any) -> None:
        self.__dict__["_attrs"] = dict(attrs)

    def __repr__(self) -> str:
        return f"<Namespace {self._attrs!r}>"


class LoopInfo:
    def __init__(self, items: list, i: int) -> None:
        n = len(items)
        self.index0, self.index, self.length = i, i + 1, n
        self.revindex, self.revindex0 = n - i, n - i - 1
        self.first, self.last = i == 0, i == n - 1
        self.previtem = items[i - 1] if i > 0 else Undefined("loop.previtem")
        self.nextitem = items[i + 1] if i + 1 < n else Undefined("loop.nextitem")


def _s(v: Any) -> str:
    return str(v)


# ------------------------------------------------------------- builtins


def _tojson(v: Any, indent: Optional[int] = None) -> Markup:
    out = json.dumps(v, sort_keys=True, indent=indent)
    return Markup(out.replace("<", "\\u003c").replace(">", "\\u003e")
                  .replace("&", "\\u0026").replace("'", "\\u0027"))


def _first(v: Any) -> Any:
    for x in v:
        return x
    return Undefined("first")


def _last(v: Any) -> Any:
    try:
        return next(iter(reversed(v)))
    except StopIteration:
        return Undefined("last")


def _default(v: Any, default: Any = "", boolean: bool = False) -> Any:
    if isinstance(v, Undefined) or (boolean and not v):
        return default
    return v


def _join(v: Any, d: str = "", attribute: Any = None) -> str:
    if attribute is not None:
        v = [_getattr(x, attribute) for x in v]
    return str(d).join(map(str, v))


def _int(v: Any, default: int = 0) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return int(float(v))
        except (TypeError, ValueError):
            return default


FILTERS: dict[str, Callable] = {
    "trim": lambda v, chars=None: _s(v).strip(chars),
    "tojson": _tojson,
    "length": len,
    "count": len,
    "default": _default,
    "d": _default,
    "upper": lambda v: _s(v).upper(),
    "lower": lambda v: _s(v).lower(),
    "capitalize": lambda v: _s(v).capitalize(),
    "first": _first,
    "last": _last,
    "join": _join,
    "string": _s,
    "list": list,
    "items": lambda v: list(v.items()) if not isinstance(v, Undefined) else [],
    "replace": lambda v, old, new, count=None: _s(v).replace(old, new, -1 if count is None else count),
    "int": _int,
}


def _iterable(v: Any) -> bool:
    try:
        iter(v)
    except TypeError:
        return False
    return True


TESTS: dict[str, Callable[[Any], bool]] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, Mapping),
    "iterable": _iterable,
    "sequence": lambda v: hasattr(v, "__len__") and hasattr(v, "__getitem__"),
    "number": lambda v: isinstance(v, Number),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
}

# the methods templates may call on values, by type
METHODS: dict[type, frozenset] = {
    str: frozenset({
        "strip", "lstrip", "rstrip", "startswith", "endswith", "split", "rsplit",
        "upper", "lower", "title", "capitalize", "replace", "find", "rfind",
        "count", "splitlines", "join", "isdigit", "isspace", "isalpha",
    }),
    dict: frozenset({"get", "items", "keys", "values"}),
    list: frozenset({"append", "index", "count"}),
}


def _raise_exception(message: Any = "") -> None:
    raise TemplateError(str(message))


GLOBALS: dict[str, Any] = {
    "range": range,
    "namespace": Namespace,
    "dict": dict,
    "raise_exception": _raise_exception,
}


def _getattr(obj: Any, name: str) -> Any:
    """jinja2's getattr: an attribute, else the item of that name, else
    Undefined; reading anything of an Undefined raises."""
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, Namespace):
        return obj._attrs.get(name, Undefined(name))
    if isinstance(obj, LoopInfo):
        return getattr(obj, name, Undefined(f"loop.{name}"))
    for typ, names in METHODS.items():
        if isinstance(obj, typ) and name in names:
            return getattr(obj, name)
    try:
        return obj[name]
    except (TypeError, LookupError):
        return Undefined(name)


def _getitem(obj: Any, key: Any) -> Any:
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[key]
    except (TypeError, LookupError):
        if isinstance(key, str):
            return _getattr(obj, key)
        return Undefined(str(key))


# ---------------------------------------------------------------- lexing

_NEWLINES = re.compile(r"\r\n|\r|\n")
_TAG_START = re.compile(r"\{\{|\{%|\{#")
_WS_RUN = re.compile(r"\s+")
_ENDS = {"{{": "}}", "{%": "%}", "{#": "#}"}


def _tag_end(src: str, i: int, end: str) -> int:
    """Index of ``end`` closing the tag whose body starts at ``i``: outside
    string literals and brackets, as jinja2's lexer finds it."""
    depth = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c in "'\"":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            i = j + 1
            continue
        if depth == 0 and src.startswith(end, i):
            return i
        if c in "([{":
            depth += 1
        elif c in ")]}" and depth:
            depth -= 1
        i += 1
    raise TemplateSyntaxError(f"unclosed tag: expected {end!r}")


def lex(source: str) -> list[tuple[str, str]]:
    """(kind, text) tokens: ("data", text), ("var", expr), ("block", stmt),
    with jinja2's whitespace control, trim_blocks and lstrip_blocks."""
    src = "\n".join(_NEWLINES.split(source))
    if src.endswith("\n"):
        src = src[:-1]
    out: list[tuple[str, str]] = []
    pos, n = 0, len(src)
    line_starting = True
    while pos < n:
        m = _TAG_START.search(src, pos)
        if m is None:
            out.append(("data", src[pos:]))
            break
        kind = m.group()
        text = src[pos:m.start()]
        body = m.end()
        sign = src[body] if body < n and src[body] in "-+" else ""
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind != "{{":
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and _WS_RUN.fullmatch(text, l_pos):
                text = text[:l_pos]
        if text:
            out.append(("data", text))
        if sign:
            body += 1
        end = _ENDS[kind]
        if kind == "{#":
            stop = src.find("#}", body)
            if stop < 0:
                raise TemplateSyntaxError("unclosed comment")
        else:
            stop = _tag_end(src, body, end)
        inner = src[body:stop]
        after = stop + 2
        if inner.endswith("-"):
            inner = inner[:-1]
            ws = _WS_RUN.match(src, after)
            if ws:
                after = ws.end()
        elif inner.endswith("+") and kind != "{{":
            inner = inner[:-1]
        elif kind != "{{" and src.startswith("\n", after):
            after += 1  # trim_blocks
        if kind == "{{":
            out.append(("var", inner))
        elif kind == "{%":
            out.append(("block", inner))
        line_starting = src[after - 1:after] == "\n"
        pos = after
    return out


# --------------------------------------------------------- expressions

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<float>\d+(?:_\d+)*\.\d+(?:_\d+)*(?:[eE][+-]?\d+)?|\d+(?:_\d+)*[eE][+-]?\d+)
  | (?P<int>\d+(?:_\d+)*)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op>\*\*|//|==|!=|<=|>=|[-+*/%~|.,:()\[\]{}<>=])
""", re.X | re.S)


def _tokens(src: str) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            raise TemplateSyntaxError(f"unexpected character {src[pos]!r} in {src!r}")
        pos = m.end()
        kind = m.lastgroup
        v = m.group()
        if kind == "ws":
            continue
        if kind == "str":
            v = v[1:-1].encode("ascii", "backslashreplace").decode("unicode-escape")
            if out and out[-1][0] == "str":  # adjacent literals concatenate
                out[-1] = ("str", out[-1][1] + v)
                continue
        elif kind == "int":
            v = int(v.replace("_", ""))
        elif kind == "float":
            v = float(v.replace("_", ""))
        out.append((kind, v))
    out.append(("end", None))
    return out


Node = Callable[["Scope"], Any]
_CONSTS = {"true": True, "false": False, "none": None, "True": True, "False": False, "None": None}
_COMPARE = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}
_ARITH = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": lambda a, b: a / b, "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
}


class _Parser:
    """Recursive descent over one expression, in jinja2's precedence
    (parser.py: condexpr > or > and > not > compare > math1 > concat >
    math2 > pow > unary + postfix + filters/tests). Each rule returns a
    closure over the render scope."""

    def __init__(self, src: str) -> None:
        self.src = src
        self.toks = _tokens(src)
        self.i = 0

    # ---- token helpers
    def peek(self, k: int = 0) -> tuple[str, Any]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> tuple[str, Any]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, kind: str, value: Any = None) -> bool:
        t = self.peek()
        return t[0] == kind and (value is None or t[1] == value)

    def skip(self, kind: str, value: Any = None) -> bool:
        if self.at(kind, value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: Any = None) -> Any:
        if not self.at(kind, value):
            raise TemplateSyntaxError(f"expected {value or kind} in {self.src!r}, got {self.peek()[1]!r}")
        return self.next()[1]

    def done(self) -> None:
        if not self.at("end"):
            raise TemplateSyntaxError(f"unexpected {self.peek()[1]!r} in {self.src!r}")

    # ---- grammar
    def expression(self) -> Node:
        expr = self.or_()
        while self.skip("name", "if"):
            cond = self.or_()
            other = self.expression() if self.skip("name", "else") else None

            def cond_expr(s, expr=expr, cond=cond, other=other):
                if cond(s):
                    return expr(s)
                return other(s) if other is not None else Undefined("if-expression")
            expr = cond_expr
        return expr

    def or_(self) -> Node:
        left = self.and_()
        while self.skip("name", "or"):
            right = self.and_()
            left = (lambda l, r: lambda s: l(s) or r(s))(left, right)
        return left

    def and_(self) -> Node:
        left = self.not_()
        while self.skip("name", "and"):
            right = self.not_()
            left = (lambda l, r: lambda s: l(s) and r(s))(left, right)
        return left

    def not_(self) -> Node:
        if self.skip("name", "not"):
            inner = self.not_()
            return lambda s: not inner(s)
        return self.compare()

    def compare(self) -> Node:
        first = self.math1()
        ops: list[tuple[Callable, Node]] = []
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                ops.append((_COMPARE[t[1]], self.math1()))
            elif self.skip("name", "in"):
                ops.append((_COMPARE["in"], self.math1()))
            elif self.at("name", "not") and self.peek(1) == ("name", "in"):
                self.i += 2
                ops.append((_COMPARE["notin"], self.math1()))
            else:
                break
        if not ops:
            return first

        def chain(s):
            a = first(s)
            for op, node in ops:
                b = node(s)
                if not op(a, b):
                    return False
                a = b
            return True
        return chain

    def _binary(self, sub: Callable[[], Node], ops: tuple) -> Node:
        left = sub()
        while self.peek()[0] == "op" and self.peek()[1] in ops:
            f = _ARITH[self.next()[1]]
            right = sub()
            left = (lambda f, l, r: lambda s: f(l(s), r(s)))(f, left, right)
        return left

    def math1(self) -> Node:
        return self._binary(self.concat, ("+", "-"))

    def concat(self) -> Node:
        parts = [self.math2()]
        while self.skip("op", "~"):
            parts.append(self.math2())
        if len(parts) == 1:
            return parts[0]
        return lambda s: "".join(str(p(s)) for p in parts)

    def math2(self) -> Node:
        return self._binary(self.pow_, ("*", "/", "//", "%"))

    def pow_(self) -> Node:
        return self._binary(self.unary, ("**",))

    def unary(self, with_filter: bool = True) -> Node:
        if self.skip("op", "-"):
            inner = self.unary(False)
            node = lambda s: -inner(s)  # noqa: E731
        elif self.skip("op", "+"):
            inner = self.unary(False)
            node = lambda s: +inner(s)  # noqa: E731
        else:
            node = self.postfix(self.primary())
        if with_filter:
            node = self.filters(node)
        return node

    def primary(self) -> Node:
        kind, v = self.next()
        if kind == "name":
            if v in _CONSTS:
                c = _CONSTS[v]
                return lambda s: c
            return lambda s: s.lookup(v)
        if kind in ("str", "int", "float"):
            return lambda s: v
        if kind == "op" and v == "(":
            if self.skip("op", ")"):
                return lambda s: ()
            first = self.expression()
            if self.skip("op", ")"):
                return first
            items = [first]
            while self.skip("op", ","):
                if self.at("op", ")"):
                    break
                items.append(self.expression())
            self.expect("op", ")")
            return lambda s: tuple(x(s) for x in items)
        if kind == "op" and v == "[":
            items = []
            while not self.at("op", "]"):
                items.append(self.expression())
                if not self.skip("op", ","):
                    break
            self.expect("op", "]")
            return lambda s: [x(s) for x in items]
        if kind == "op" and v == "{":
            pairs = []
            while not self.at("op", "}"):
                k = self.expression()
                self.expect("op", ":")
                pairs.append((k, self.expression()))
                if not self.skip("op", ","):
                    break
            self.expect("op", "}")
            return lambda s: {k(s): x(s) for k, x in pairs}
        raise TemplateSyntaxError(f"unexpected {v!r} in {self.src!r}")

    def postfix(self, node: Node) -> Node:
        while True:
            if self.skip("op", "."):
                kind, name = self.next()
                if kind == "int":
                    node = (lambda n, k: lambda s: _getitem(n(s), k))(node, name)
                elif kind == "name":
                    node = (lambda n, k: lambda s: _getattr(n(s), k))(node, name)
                else:
                    raise TemplateSyntaxError(f"bad attribute in {self.src!r}")
            elif self.skip("op", "["):
                node = self.subscript(node)
            elif self.at("op", "("):
                node = self.call(node)
            else:
                return node

    def subscript(self, node: Node) -> Node:
        parts: list[Optional[Node]] = []
        cur: Optional[Node] = None
        is_slice = False
        while not self.at("op", "]"):
            if self.skip("op", ":"):
                parts.append(cur)
                cur = None
                is_slice = True
            else:
                cur = self.expression()
        self.expect("op", "]")
        parts.append(cur)
        if not is_slice:
            key = parts[0]
            if key is None:
                raise TemplateSyntaxError(f"empty subscript in {self.src!r}")
            return lambda s: _getitem(node(s), key(s))
        if len(parts) > 3:
            raise TemplateSyntaxError(f"bad slice in {self.src!r}")
        parts += [None] * (3 - len(parts))

        def sl(s):
            obj = node(s)
            if isinstance(obj, Undefined):
                obj._fail()
            return obj[slice(*(p(s) if p is not None else None for p in parts))]
        return sl

    def args(self) -> tuple[list[Node], dict[str, Node]]:
        self.expect("op", "(")
        pos: list[Node] = []
        kw: dict[str, Node] = {}
        while not self.at("op", ")"):
            if self.peek()[0] == "name" and self.peek(1) == ("op", "="):
                name = self.next()[1]
                self.next()
                kw[name] = self.expression()
            else:
                pos.append(self.expression())
            if not self.skip("op", ","):
                break
        self.expect("op", ")")
        return pos, kw

    def call(self, node: Node) -> Node:
        pos, kw = self.args()

        def do_call(s):
            fn = node(s)
            if isinstance(fn, Undefined):
                fn._fail()
            if not callable(fn):
                raise TemplateError(f"{fn!r} is not callable")
            return fn(*(p(s) for p in pos), **{k: v(s) for k, v in kw.items()})
        return do_call

    def filters(self, node: Node) -> Node:
        while True:
            if self.skip("op", "|"):
                name = self.expect("name")
                if name not in FILTERS:
                    raise TemplateSyntaxError(f"unsupported filter {name!r}")
                f = FILTERS[name]
                pos, kw = self.args() if self.at("op", "(") else ([], {})
                node = (lambda f, n, pos, kw: lambda s: f(
                    n(s), *(p(s) for p in pos), **{k: v(s) for k, v in kw.items()}))(f, node, pos, kw)
            elif self.skip("name", "is"):
                negate = self.skip("name", "not")
                name = self.expect("name")
                if name not in TESTS:
                    raise TemplateSyntaxError(f"unsupported test {name!r}")
                t = TESTS[name]
                node = (lambda t, n, neg: lambda s: t(n(s)) != neg)(t, node, negate)
            elif self.at("op", "("):
                node = self.call(node)
            else:
                return node


def parse_expression(src: str) -> Node:
    p = _Parser(src)
    node = p.expression()
    p.done()
    return node


# ------------------------------------------------------------ statements


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["Scope"] = None, vars: Optional[dict] = None) -> None:
        self.vars = vars if vars is not None else {}
        self.parent = parent

    def lookup(self, name: str) -> Any:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return GLOBALS.get(name, Undefined(name))


Stmt = Callable[[Scope, list], None]


def _render_block(body: list[Stmt], scope: Scope, out: list) -> None:
    for st in body:
        st(scope, out)


def _targets(src: str) -> list[str]:
    names = [t.strip() for t in src.split(",")]
    if not all(re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", n) for n in names):
        raise TemplateSyntaxError(f"unsupported loop target {src!r}")
    return names


class _Builder:
    """Turns the lexed tokens into a tree of statement closures."""

    def __init__(self, tokens: list[tuple[str, str]]) -> None:
        self.toks = tokens
        self.i = 0

    def block(self, until: tuple[str, ...]) -> tuple[list[Stmt], Optional[str], str]:
        """Statements up to a block tag whose keyword is in ``until``;
        returns them, that keyword (None at the end) and its rest."""
        body: list[Stmt] = []
        while self.i < len(self.toks):
            kind, text = self.toks[self.i]
            self.i += 1
            if kind == "data":
                body.append(lambda s, out, t=text: out.append(t))
            elif kind == "var":
                node = parse_expression(text)
                body.append(lambda s, out, n=node: out.append(str(n(s))))
            else:
                m = re.match(r"\s*([A-Za-z_]\w*)\s*(.*?)\s*$", text, re.S)
                if m is None:
                    raise TemplateSyntaxError(f"bad tag {text!r}")
                word, rest = m.groups()
                if word in until:
                    return body, word, rest
                body.append(self.statement(word, rest))
        if until:
            raise TemplateSyntaxError(f"missing {' / '.join(until)}")
        return body, None, ""

    def statement(self, word: str, rest: str) -> Stmt:
        if word == "if":
            return self.if_(rest)
        if word == "for":
            return self.for_(rest)
        if word == "set":
            return self.set_(rest)
        raise TemplateSyntaxError(f"unsupported tag {word!r}")

    def if_(self, cond_src: str) -> Stmt:
        branches: list[tuple[Optional[Node], list[Stmt]]] = []
        cond: Optional[Node] = parse_expression(cond_src)
        while True:
            body, word, rest = self.block(("elif", "else", "endif"))
            branches.append((cond, body))
            if word == "endif":
                break
            if word == "elif":
                cond = parse_expression(rest)
            else:
                cond = None
                body, word, _ = self.block(("endif",))
                branches.append((None, body))
                break

        def run(s, out):
            for c, body in branches:
                if c is None or c(s):
                    _render_block(body, s, out)
                    return
        return run

    def for_(self, src: str) -> Stmt:
        m = re.fullmatch(r"(.+?)\s+in\s+(.+)", src, re.S)
        if m is None:
            raise TemplateSyntaxError(f"bad for statement {src!r}")
        names = _targets(m.group(1))
        p = _Parser(m.group(2))
        seq = p.or_()  # jinja2 parses the iterable without a conditional
        filt = p.expression() if p.skip("name", "if") else None
        if p.skip("name", "recursive"):
            raise TemplateSyntaxError("recursive loops are not supported")
        p.done()
        body, word, _ = self.block(("else", "endfor"))
        else_body: list[Stmt] = []
        if word == "else":
            else_body, _, _ = self.block(("endfor",))

        def bind(scope: Scope, item: Any) -> None:
            if len(names) == 1:
                scope.vars[names[0]] = item
            else:
                vals = list(item)
                if len(vals) != len(names):
                    raise TemplateError(f"cannot unpack {item!r} into {names}")
                scope.vars.update(zip(names, vals))

        def run(s, out):
            it = seq(s)
            items = list(it)
            if filt is not None:
                kept = []
                for x in items:
                    probe = Scope(s)
                    bind(probe, x)
                    if filt(probe):
                        kept.append(x)
                items = kept
            if not items:
                _render_block(else_body, s, out)
                return
            for i, x in enumerate(items):
                inner = Scope(s, {"loop": LoopInfo(items, i)})
                bind(inner, x)
                _render_block(body, inner, out)
        return run

    def set_(self, src: str) -> Stmt:
        m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*)(?:\.([A-Za-z_][A-Za-z0-9_]*))?\s*(=\s*(.*))?", src, re.S)
        if m is None:
            raise TemplateSyntaxError(f"unsupported set statement {src!r}")
        name, attr, has_value, value_src = m.groups()
        if has_value:
            value = parse_expression(value_src)
        else:
            if attr:
                raise TemplateSyntaxError(f"unsupported set block {src!r}")
            body, _, _ = self.block(("endset",))

            def value(s):
                buf: list[str] = []
                _render_block(body, Scope(s), buf)
                return "".join(buf)

        def run(s, out):
            v = value(s)
            if attr is None:
                s.vars[name] = v
                return
            ns = s.lookup(name)
            if not isinstance(ns, Namespace):
                raise TemplateError(f"cannot assign attribute on non-namespace {name!r}")
            ns._attrs[attr] = v
        return run


class Template:
    """A parsed template; ``render(**vars)`` returns its text."""

    def __init__(self, source: str) -> None:
        self.source = source
        self._body, _, _ = _Builder(lex(source)).block(())

    def render(self, **variables: Any) -> str:
        out: list[str] = []
        _render_block(self._body, Scope(vars=dict(variables)), out)
        return "".join(out)
