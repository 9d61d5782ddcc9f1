"""Jinja2-subset template engine for GGUF chat templates.

TPU-framework analogue of the reference's vendored minja engine
(reference: vendor/minja/minja.hpp, wired through common/chat.cpp:130+):
executes ``tokenizer.chat_template`` strings directly instead of detecting
~40 hardcoded families (reference: src/llama-chat.cpp:35-120). Semantics
match the HuggingFace chat-template environment — which is also what minja
emulates — i.e. jinja2 with ``trim_blocks=True, lstrip_blocks=True``, loop
controls (break/continue), ``tojson`` with ``ensure_ascii=False``,
``raise_exception`` and ``strftime_now`` globals.

Standalone: no dependency on the jinja2 package (tests use jinja2 only as
a parity oracle). Evaluation is sandboxed — attribute access goes through
per-type method whitelists, never raw ``getattr`` on arbitrary objects.
"""

from __future__ import annotations

import ast as _pyast
import json
import re
from datetime import datetime


class TemplateError(Exception):
    pass


# ---------------------------------------------------------------------------
# Runtime values


class Undefined:
    """Lenient undefined: renders '', is falsy, chains attribute access."""

    __slots__ = ("name",)

    def __init__(self, name: str = ""):
        self.name = name

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, Undefined)

    def __ne__(self, other):
        return not isinstance(other, Undefined)

    def __hash__(self):
        return 0

    def __str__(self):
        return ""

    def __repr__(self):
        return f"Undefined({self.name!r})"

    def __iter__(self):
        # jinja2 3.x default Undefined: iterating yields nothing
        return iter(())

    def __len__(self):
        # jinja2 3.x default Undefined: len() is 0
        return 0


class Namespace:
    """`namespace()` object: mutable attribute bag that pierces scopes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Markup(str):
    """Result of `| safe` / macro calls. No autoescaping of output, but
    markupsafe's `+` semantics are modeled: concatenating a Markup with a
    plain str HTML-escapes the plain side (real HF templates rely on this,
    e.g. functionary-v3.1's `"..."|safe + name` produces `&#34;`). The `~`
    operator does NOT escape (it goes through _to_text/join, like jinja2)."""

    def __add__(self, other):
        if isinstance(other, Markup):
            return Markup(str.__add__(self, other))
        if isinstance(other, str):
            return Markup(str.__add__(self, _html_escape(other)))
        return NotImplemented  # e.g. Markup + dict -> TypeError, like markupsafe

    def __radd__(self, other):
        # tried FIRST by Python for `plain_str + markup` since Markup
        # subclasses str — matching markupsafe, the plain side is escaped
        if isinstance(other, str):
            return Markup(_html_escape(other) + str(self))
        return NotImplemented


class _LoopVar:
    __slots__ = ("index0", "length", "_items")

    def __init__(self, length, items):
        self.index0 = 0
        self.length = length
        self._items = items

    @property
    def index(self):
        return self.index0 + 1

    @property
    def first(self):
        return self.index0 == 0

    @property
    def last(self):
        return self.index0 == self.length - 1

    @property
    def revindex(self):
        return self.length - self.index0

    @property
    def revindex0(self):
        return self.length - self.index0 - 1

    @property
    def previtem(self):
        return self._items[self.index0 - 1] if self.index0 > 0 else Undefined("loop.previtem")

    @property
    def nextitem(self):
        return (
            self._items[self.index0 + 1]
            if self.index0 + 1 < self.length
            else Undefined("loop.nextitem")
        )

    _ATTRS = (
        "index", "index0", "first", "last", "length",
        "revindex", "revindex0", "previtem", "nextitem",
    )


class _BreakLoop(Exception):
    pass


class _ContinueLoop(Exception):
    pass


def _to_text(v) -> str:
    if isinstance(v, Undefined):
        return ""
    if v is True:
        return "True"
    if v is False:
        return "False"
    if v is None:
        return "None"
    return str(v)


def _is_true(v) -> bool:
    if isinstance(v, Undefined):
        return False
    return bool(v)


# ---------------------------------------------------------------------------
# Template-level lexer

_TAG_OPEN = re.compile(r"\{[{%#]")
_LSTRIP = re.compile(r"(?:^|\n)[ \t]*\Z")


def _scan_close(src: str, pos: int, close: str) -> int:
    """Index of `close` starting at/after pos, skipping quoted strings."""
    n = len(src)
    while pos < n:
        c = src[pos]
        if c in "'\"":
            q = c
            pos += 1
            while pos < n:
                if src[pos] == "\\":
                    pos += 2
                    continue
                if src[pos] == q:
                    break
                pos += 1
            pos += 1
            continue
        if src.startswith(close, pos):
            return pos
        pos += 1
    raise TemplateError(f"unclosed tag (expected {close!r})")


def _lex(src: str):
    """-> list of ('text', s) | ('expr', s) | ('stmt', s) with whitespace
    control (trim_blocks / lstrip_blocks / `-` / `+`) already applied."""
    parts = []
    i = 0
    pending = None  # whitespace stripping owed to the *next* text chunk
    n = len(src)
    while True:
        m = _TAG_OPEN.search(src, i)
        if m is None:
            text = src[i:]
            if pending == "all":
                text = text.lstrip()
            elif pending == "newline":
                if text.startswith("\r\n"):
                    text = text[2:]
                elif text.startswith("\n"):
                    text = text[1:]
            if text:
                parts.append(("text", text))
            return parts
        j = m.start()
        kind_ch = src[j + 1]
        text = src[i:j]
        if pending == "all":
            text = text.lstrip()
        elif pending == "newline":
            if text.startswith("\r\n"):
                text = text[2:]
            elif text.startswith("\n"):
                text = text[1:]
        k = j + 2
        minus = k < n and src[k] == "-"
        plus = k < n and src[k] == "+"
        if minus or plus:
            k += 1
        if minus:
            text = text.rstrip()
        elif kind_ch in "%#" and not plus:
            # lstrip_blocks: strip [ \t]* before the tag ONLY if the tag sits
            # at a line start in the RAW source (jinja2 checks the source
            # line, not the current chunk — a chunk after `}}` is mid-line)
            p = j - 1
            while p >= 0 and src[p] in " \t":
                p -= 1
            if p < 0 or src[p] == "\n":
                lm = _LSTRIP.search(text)
                if lm:
                    text = text[: lm.start()] + ("\n" if lm.group().startswith("\n") else "")
        if text:
            parts.append(("text", text))
        close = {"{": "}}", "%": "%}", "#": "#}"}[kind_ch]
        if kind_ch == "#":
            # comments end at the first '#}' — no quote tracking (jinja2
            # semantics; real templates write apostrophes in comments)
            e = src.find(close, k)
            if e < 0:
                raise TemplateError("unclosed tag (expected '#}')")
        else:
            e = _scan_close(src, k, close)
        inner = src[k:e].strip()
        cminus = inner.endswith("-")
        cplus = inner.endswith("+")
        if cminus or cplus:
            inner = inner[:-1].rstrip()
        if kind_ch == "{":
            parts.append(("expr", inner))
        elif kind_ch == "%":
            parts.append(("stmt", inner))
        # comments emit nothing
        if cminus:
            pending = "all"
        elif kind_ch in "%#" and not cplus:
            pending = "newline"
        else:
            pending = None
        i = e + 2


# ---------------------------------------------------------------------------
# Expression lexer/parser

_EXPR_TOKEN = re.compile(
    r"""\s*(?:
      (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>\*\*|//|==|!=|<=|>=|[-+*/%~<>()\[\]{}.,:|=])
    )""",
    re.X | re.S,
)

_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"',
    "b": "\b", "f": "\f", "a": "\a", "v": "\v", "0": "\0",
}


def _unescape(body: str) -> str:
    """jinja2 string-literal semantics (unicode_escape: unknown escapes
    pass through verbatim, raw newlines allowed)."""
    if "\\" not in body:
        return body
    out = []
    i = 0
    n = len(body)
    while i < n:
        c = body[i]
        if c == "\\" and i + 1 < n:
            nc = body[i + 1]
            if nc == "x" and i + 3 < n:
                try:
                    out.append(chr(int(body[i + 2:i + 4], 16)))
                    i += 4
                    continue
                except ValueError:
                    pass
            if nc == "u" and i + 5 < n:
                try:
                    out.append(chr(int(body[i + 2:i + 6], 16)))
                    i += 6
                    continue
                except ValueError:
                    pass
            if nc in _ESCAPES:
                out.append(_ESCAPES[nc])
                i += 2
                continue
            out.append("\\" + nc)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)

_KEYWORDS = {
    "true": True, "True": True, "false": False, "False": False,
    "none": None, "None": None, "null": None,
}


def _tokenize_expr(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _EXPR_TOKEN.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            raise TemplateError(f"bad token at {src[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            t = m.group("num")
            toks.append(("num", float(t) if ("." in t or "e" in t or "E" in t) else int(t)))
        elif m.lastgroup == "str":
            toks.append(("str", _unescape(m.group("str")[1:-1])))
        elif m.lastgroup == "name":
            toks.append(("name", m.group("name")))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("end", None))
    return toks


# Expression AST: each node is a callable(ctx) -> value, built as closures.


class _ExprParser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_op(self, *ops):
        k, v = self.toks[self.i]
        return k == "op" and v in ops

    def at_name(self, *names):
        k, v = self.toks[self.i]
        return k == "name" and v in names

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise TemplateError(f"expected {op!r}, got {v!r}")

    def done(self):
        return self.toks[self.i][0] == "end"

    # precedence (low -> high): cond, or, and, not, comparison,
    # add/sub, ~, mul/div/%, **, unary, postfix+filters
    def parse(self):
        e = self.parse_cond()
        return e

    def parse_cond(self):
        e = self.parse_or()
        if self.at_name("if"):
            self.next()
            cond = self.parse_or()
            if self.at_name("else"):
                self.next()
                alt = self.parse_cond()
            else:
                alt = lambda ctx: Undefined("cond")
            t, c, a = e, cond, alt
            return lambda ctx: t(ctx) if _is_true(c(ctx)) else a(ctx)
        return e

    def parse_or(self):
        e = self.parse_and()
        while self.at_name("or"):
            self.next()
            r = self.parse_and()
            le, re_ = e, r
            e = lambda ctx, le=le, re_=re_: (lambda lv: lv if _is_true(lv) else re_(ctx))(le(ctx))
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.at_name("and"):
            self.next()
            r = self.parse_not()
            le, re_ = e, r
            e = lambda ctx, le=le, re_=re_: (lambda lv: re_(ctx) if _is_true(lv) else lv)(le(ctx))
        return e

    def parse_not(self):
        if self.at_name("not"):
            self.next()
            e = self.parse_not()
            return lambda ctx: not _is_true(e(ctx))
        return self.parse_comparison()

    def parse_comparison(self):
        e = self.parse_add()
        ops = []
        while True:
            if self.at_op("==", "!=", "<", ">", "<=", ">="):
                op = self.next()[1]
                ops.append((op, self.parse_add()))
            elif self.at_name("in"):
                self.next()
                ops.append(("in", self.parse_add()))
            elif self.at_name("not") and self.toks[self.i + 1] == ("name", "in"):
                self.next()
                self.next()
                ops.append(("not in", self.parse_add()))
            elif self.at_name("is"):
                self.next()
                negate = False
                if self.at_name("not"):
                    self.next()
                    negate = True
                tk, tname = self.next()
                if tk != "name":
                    raise TemplateError("expected test name after 'is'")
                targs = []
                if self.at_op("("):
                    self.next()
                    targs = self._parse_call_args()[0]
                e = self._make_test(e, tname, targs, negate)
                continue
            else:
                break
        if ops:
            base = e

            def chain(ctx, base=base, ops=ops):
                left = base(ctx)
                for op, rf in ops:
                    right = rf(ctx)
                    if not _compare(op, left, right):
                        return False
                    left = right
                return True

            return chain
        return e

    def _make_test(self, e, name, targs, negate):
        test = _TESTS.get(name)
        if test is None:
            raise TemplateError(f"unknown test {name!r}")

        def run(ctx, e=e, test=test, targs=targs, negate=negate):
            v = e(ctx)
            r = test(v, *[a(ctx) for a in targs])
            return (not r) if negate else r

        return run

    def parse_add(self):
        e = self.parse_concat()
        while self.at_op("+", "-"):
            op = self.next()[1]
            r = self.parse_concat()
            e = (lambda ctx, le=e, re_=r: _arith_add(le(ctx), re_(ctx))) if op == "+" else (
                lambda ctx, le=e, re_=r: le(ctx) - re_(ctx)
            )
        return e

    def parse_concat(self):
        e = self.parse_mul()
        while self.at_op("~"):
            self.next()
            r = self.parse_mul()
            e = lambda ctx, le=e, re_=r: _to_text(le(ctx)) + _to_text(re_(ctx))
        return e

    def parse_mul(self):
        e = self.parse_pow()
        while self.at_op("*", "/", "//", "%"):
            op = self.next()[1]
            r = self.parse_pow()
            if op == "*":
                e = lambda ctx, le=e, re_=r: le(ctx) * re_(ctx)
            elif op == "/":
                e = lambda ctx, le=e, re_=r: le(ctx) / re_(ctx)
            elif op == "//":
                e = lambda ctx, le=e, re_=r: le(ctx) // re_(ctx)
            else:
                e = lambda ctx, le=e, re_=r: le(ctx) % re_(ctx)
        return e

    def parse_pow(self):
        e = self.parse_unary()
        if self.at_op("**"):
            self.next()
            r = self.parse_pow()
            e = lambda ctx, le=e, re_=r: le(ctx) ** re_(ctx)
        return e

    def parse_unary(self):
        if self.at_op("-"):
            self.next()
            e = self.parse_unary()
            return lambda ctx: -e(ctx)
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.at_op("."):
                self.next()
                k, name = self.next()
                if k not in ("name", "num"):
                    raise TemplateError("expected attribute name")
                e = lambda ctx, oe=e, name=name: _get_attr(oe(ctx), name)
            elif self.at_op("["):
                self.next()
                e = self._parse_subscript(e)
            elif self.at_op("("):
                self.next()
                args, kwargs = self._parse_call_args()
                e = lambda ctx, fe=e, args=args, kwargs=kwargs: _call(
                    fe(ctx), [a(ctx) for a in args], {k: v(ctx) for k, v in kwargs.items()}
                )
            elif self.at_op("|"):
                self.next()
                k, fname = self.next()
                if k != "name":
                    raise TemplateError("expected filter name after '|'")
                args, kwargs = [], {}
                if self.at_op("("):
                    self.next()
                    args, kwargs = self._parse_call_args()
                e = lambda ctx, ve=e, fname=fname, args=args, kwargs=kwargs: _apply_filter(
                    fname, ve(ctx), [a(ctx) for a in args],
                    {k: v(ctx) for k, v in kwargs.items()},
                )
            else:
                return e

    def _parse_subscript(self, e):
        # supports a, a:b, a:b:c with any part omitted
        pieces = [None, None, None]
        idx = 0
        is_slice = False
        while not self.at_op("]"):
            if self.at_op(":"):
                self.next()
                idx += 1
                is_slice = True
                continue
            pieces[idx] = self.parse()
        self.expect_op("]")
        if not is_slice:
            key = pieces[0]
            return lambda ctx, oe=e, key=key: _get_item(oe(ctx), key(ctx))
        a, b, c = pieces

        def do_slice(ctx, oe=e, a=a, b=b, c=c):
            obj = oe(ctx)
            return obj[slice(a(ctx) if a else None, b(ctx) if b else None, c(ctx) if c else None)]

        return do_slice

    def _parse_call_args(self):
        args, kwargs = [], {}
        while not self.at_op(")"):
            k, v = self.peek()
            if k == "name" and self.toks[self.i + 1] == ("op", "="):
                self.next()
                self.next()
                kwargs[v] = self.parse()
            else:
                args.append(self.parse())
            if self.at_op(","):
                self.next()
        self.expect_op(")")
        return args, kwargs

    def parse_primary(self):
        k, v = self.next()
        if k == "num" or k == "str":
            return lambda ctx, v=v: v
        if k == "name":
            if v in _KEYWORDS:
                lit = _KEYWORDS[v]
                return lambda ctx, lit=lit: lit
            return lambda ctx, v=v: ctx.lookup(v)
        if k == "op" and v == "(":
            items = [self.parse()]
            is_tuple = False
            while self.at_op(","):
                self.next()
                is_tuple = True
                if self.at_op(")"):
                    break
                items.append(self.parse())
            self.expect_op(")")
            if is_tuple:
                return lambda ctx, items=items: tuple(i(ctx) for i in items)
            return items[0]
        if k == "op" and v == "[":
            items = []
            while not self.at_op("]"):
                items.append(self.parse())
                if self.at_op(","):
                    self.next()
            self.expect_op("]")
            return lambda ctx, items=items: [i(ctx) for i in items]
        if k == "op" and v == "{":
            pairs = []
            while not self.at_op("}"):
                kx = self.parse()
                self.expect_op(":")
                vx = self.parse()
                pairs.append((kx, vx))
                if self.at_op(","):
                    self.next()
            self.expect_op("}")
            return lambda ctx, pairs=pairs: {kx(ctx): vx(ctx) for kx, vx in pairs}
        raise TemplateError(f"unexpected token {v!r}")


def _parse_expr(src: str):
    p = _ExprParser(_tokenize_expr(src))
    e = p.parse()
    if not p.done():
        raise TemplateError(f"trailing tokens in expression {src!r}")
    return e


def _compare(op, a, b):
    if op == "==":
        try:
            return a == b
        except TypeError:
            return False
    if op == "!=":
        try:
            return a != b
        except TypeError:
            return True
    if op == "in":
        return _op_in(a, b)
    if op == "not in":
        return not _op_in(a, b)
    if isinstance(a, Undefined) or isinstance(b, Undefined):
        raise TemplateError("ordering comparison with undefined")
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    return a >= b


def _op_in(a, b):
    if isinstance(b, Undefined):
        return False
    if isinstance(a, Undefined):
        a = None
    try:
        return a in b
    except TypeError:
        return False


def _arith_add(a, b):
    if isinstance(a, Undefined) or isinstance(b, Undefined):
        raise TemplateError("'+' with undefined operand")
    return a + b


# ---------------------------------------------------------------------------
# Attribute / item / call sandbox

_STR_METHODS = frozenset({
    "strip", "lstrip", "rstrip", "startswith", "endswith", "split", "rsplit",
    "replace", "upper", "lower", "title", "capitalize", "find", "rfind",
    "count", "index", "join", "splitlines", "removeprefix", "removesuffix",
    "format", "encode", "isalpha", "isdigit", "islower", "isupper", "zfill",
})
_LIST_METHODS = frozenset({"append", "insert", "pop", "index", "count", "remove", "reverse", "extend"})
_DICT_METHODS = frozenset({"get", "items", "keys", "values", "pop", "update", "copy", "setdefault"})


def _get_attr(obj, name):
    if isinstance(name, int) and isinstance(obj, (list, tuple)):
        # map(attribute=1) on tuples/lists subscripts, like jinja2's getitem
        try:
            return obj[name]
        except IndexError:
            return Undefined(str(name))
    name = str(name)
    if isinstance(obj, Undefined):
        return Undefined(f"{obj.name}.{name}")
    if isinstance(obj, Namespace):
        try:
            return obj.__dict__[name]
        except KeyError:
            return Undefined(name)
    if isinstance(obj, _LoopVar):
        if name in _LoopVar._ATTRS:
            return getattr(obj, name)
        return Undefined(f"loop.{name}")
    if isinstance(obj, dict):
        if name in _DICT_METHODS:
            return getattr(obj, name)
        if name in obj:
            return obj[name]
        return Undefined(name)
    if isinstance(obj, str):
        if name in _STR_METHODS:
            return getattr(obj, name)
        return Undefined(name)
    if isinstance(obj, list):
        if name in _LIST_METHODS:
            return getattr(obj, name)
        return Undefined(name)
    if isinstance(obj, (int, float, bool, tuple)) or obj is None:
        return Undefined(name)
    # last resort for plain data objects (e.g. datetime in strftime_now)
    if name.startswith("_"):
        raise TemplateError(f"access to {name!r} is not allowed")
    return Undefined(name)


def _get_item(obj, key):
    if isinstance(obj, Undefined):
        return Undefined(f"{obj.name}[...]")
    if isinstance(obj, dict):
        if isinstance(key, Undefined):
            return Undefined("key")
        if key in obj:
            return obj[key]
        return Undefined(str(key))
    if isinstance(obj, (list, tuple, str)):
        try:
            return obj[key]
        except (IndexError, TypeError):
            return Undefined(str(key))
    return Undefined(str(key))


def _call(fn, args, kwargs):
    if isinstance(fn, Undefined):
        raise TemplateError(f"'{fn.name}' is undefined (call)")
    if not callable(fn):
        raise TemplateError(f"{fn!r} is not callable")
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Tests

def _test_defined(v):
    return not isinstance(v, Undefined)


_TESTS = {
    "defined": _test_defined,
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, dict),
    "sequence": lambda v: isinstance(v, (list, tuple, str, dict)),
    "iterable": lambda v: isinstance(v, (list, tuple, str, dict)) or hasattr(v, "__iter__"),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "float": lambda v: isinstance(v, float),
    "boolean": lambda v: isinstance(v, bool),
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "callable": callable,
    "lower": lambda v: isinstance(v, str) and v.islower(),
    "upper": lambda v: isinstance(v, str) and v.isupper(),
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
    "divisibleby": lambda v, d: v % d == 0,
    "sameas": lambda v, o: v is o,
    "equalto": lambda v, o: v == o,
    "eq": lambda v, o: v == o,
    "ne": lambda v, o: v != o,
    "lt": lambda v, o: v < o,
    "le": lambda v, o: v <= o,
    "gt": lambda v, o: v > o,
    "ge": lambda v, o: v >= o,
    "in": lambda v, seq: _op_in(v, seq),
}


# ---------------------------------------------------------------------------
# Filters


def _f_tojson(v, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
    # matches the HF chat-template override of jinja's builtin tojson
    return json.dumps(_strip_undefined(v), ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _strip_undefined(v):
    if isinstance(v, Undefined):
        return None
    if isinstance(v, dict):
        return {k: _strip_undefined(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_strip_undefined(x) for x in v]
    return v


def _f_default(v, default="", boolean=False):
    if isinstance(v, Undefined):
        return default
    if boolean and not v:
        return default
    return v


def _f_join(v, sep="", attribute=None):
    items = list(v)
    if attribute is not None:
        items = [_get_attr(x, attribute) for x in items]
    return _to_text(sep).join(_to_text(x) for x in items)


def _f_indent(v, width=4, first=False, blank=False):
    pad = " " * width if isinstance(width, int) else str(width)
    newline = "\n"
    lines = _to_text(v).split(newline)
    out = []
    for i, line in enumerate(lines):
        if i == 0 and not first:
            out.append(line)
        elif not line and not blank:
            out.append(line)
        else:
            out.append(pad + line)
    return newline.join(out)


def _f_map(v, *args, **kwargs):
    items = list(v) if v else []  # jinja2 guards `if value:` — falsy -> empty
    if "attribute" in kwargs:
        attr = kwargs["attribute"]
        has_default = "default" in kwargs
        dflt = kwargs.get("default")
        out = []
        for x in items:
            r = _get_attr(x, attr)
            if isinstance(r, Undefined) and has_default:
                r = dflt
            out.append(r)
        return out
    if args:
        fname = args[0]
        return [_apply_filter(fname, x, list(args[1:]), {}) for x in items]
    return items


def _resolve_test(args):
    """(attr-less) select/reject arg list -> predicate."""
    if not args:
        return _is_true, []
    tname = args[0]
    test = _TESTS.get(tname)
    if test is None:
        raise TemplateError(f"unknown test {tname!r}")
    return test, list(args[1:])


def _f_select(v, *args):
    test, extra = _resolve_test(args)
    return [x for x in (v or ()) if test(x, *extra)]


def _f_reject(v, *args):
    test, extra = _resolve_test(args)
    return [x for x in (v or ()) if not test(x, *extra)]


def _f_selectattr(v, attr, *args):
    test, extra = _resolve_test(args)
    return [x for x in (v or ()) if test(_get_attr(x, attr), *extra)]


def _f_rejectattr(v, attr, *args):
    test, extra = _resolve_test(args)
    return [x for x in (v or ()) if not test(_get_attr(x, attr), *extra)]


def _sort_key(case_sensitive):
    def key(x):
        if isinstance(x, str) and not case_sensitive:
            return x.lower()
        return x

    return key


def _f_sort(v, reverse=False, case_sensitive=False, attribute=None):
    items = list(v)
    base = _sort_key(case_sensitive)
    if attribute is not None:
        return sorted(items, key=lambda x: base(_get_attr(x, attribute)), reverse=reverse)
    return sorted(items, key=base, reverse=reverse)


def _f_dictsort(v, case_sensitive=False, by="key", reverse=False):
    pos = 0 if by == "key" else 1
    base = _sort_key(case_sensitive)
    return sorted(v.items(), key=lambda kv: base(kv[pos]), reverse=reverse)


def _f_unique(v, case_sensitive=False, attribute=None):
    seen = set()
    out = []
    base = _sort_key(case_sensitive)
    for x in v:
        k = base(_get_attr(x, attribute)) if attribute is not None else base(x)
        try:
            new = k not in seen
            if new:
                seen.add(k)
        except TypeError:
            new = True
        if new:
            out.append(x)
    return out


def _f_replace(v, old, new, count=-1):
    return _to_text(v).replace(old, new, count if count is not None else -1)


def _f_int(v, default=0, base=10):
    try:
        if isinstance(v, str):
            return int(v, base)
        return int(v)
    except (TypeError, ValueError):
        return default


def _f_float(v, default=0.0):
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _f_items(v):
    if isinstance(v, Undefined):
        return []
    if not isinstance(v, dict):
        raise TemplateError("items filter requires a mapping")
    return list(v.items())


def _f_length(v):
    return len(v)  # Undefined.__len__ -> 0, matching jinja2 3.x


_FILTERS = {
    "abs": abs,
    "capitalize": lambda v: _to_text(v).capitalize(),
    "count": _f_length,
    "d": _f_default,
    "default": _f_default,
    "dictsort": _f_dictsort,
    "e": lambda v: _html_escape(_to_text(v)),
    "escape": lambda v: _html_escape(_to_text(v)),
    "first": lambda v: next(iter(v), Undefined("first")),
    "float": _f_float,
    "indent": _f_indent,
    "int": _f_int,
    "items": _f_items,
    "join": _f_join,
    "last": lambda v: (list(v) or [Undefined("last")])[-1],
    "length": _f_length,
    "list": lambda v: list(v),
    "lower": lambda v: _to_text(v).lower(),
    "map": _f_map,
    "max": lambda v, **kw: max(v),
    "min": lambda v, **kw: min(v),
    "reject": _f_reject,
    "rejectattr": _f_rejectattr,
    "replace": _f_replace,
    "reverse": lambda v: list(reversed(list(v))),
    "round": lambda v, precision=0, method="common": round(v, precision),
    "safe": lambda v: Markup(_to_text(v)),
    "select": _f_select,
    "selectattr": _f_selectattr,
    "sort": _f_sort,
    "string": _to_text,
    "sum": lambda v, start=0: sum(v, start),
    "title": lambda v: _to_text(v).title(),
    "tojson": _f_tojson,
    "trim": lambda v, chars=None: _to_text(v).strip(chars),
    "unique": _f_unique,
    "upper": lambda v: _to_text(v).upper(),
    "urlencode": lambda v: __import__("urllib.parse", fromlist=["quote"]).quote(_to_text(v)),
    "wordcount": lambda v: len(_to_text(v).split()),
}


def _html_escape(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace("'", "&#39;").replace('"', "&#34;")
    )


def _apply_filter(name, value, args, kwargs):
    f = _FILTERS.get(name)
    if f is None:
        raise TemplateError(f"unknown filter {name!r}")
    return f(value, *args, **kwargs)


# ---------------------------------------------------------------------------
# Statement AST


class Context:
    __slots__ = ("scopes",)

    def __init__(self, scopes):
        self.scopes = scopes

    def lookup(self, name):
        for s in reversed(self.scopes):
            if name in s:
                return s[name]
        return Undefined(name)

    def set(self, name, value):
        self.scopes[-1][name] = value

    def child(self):
        return Context(self.scopes + [{}])


class _Text:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def render(self, ctx, out):
        out.append(self.s)


class _Output:
    __slots__ = ("expr",)

    def __init__(self, expr):
        self.expr = expr

    def render(self, ctx, out):
        out.append(_to_text(self.expr(ctx)))


class _If:
    __slots__ = ("branches", "orelse")

    def __init__(self, branches, orelse):
        self.branches = branches  # [(cond_expr, body)]
        self.orelse = orelse

    def render(self, ctx, out):
        for cond, body in self.branches:
            if _is_true(cond(ctx)):
                for n in body:
                    n.render(ctx, out)
                return
        for n in self.orelse:
            n.render(ctx, out)


class _For:
    __slots__ = ("targets", "iter_expr", "cond", "body", "orelse")

    def __init__(self, targets, iter_expr, cond, body, orelse):
        self.targets = targets
        self.iter_expr = iter_expr
        self.cond = cond
        self.body = body
        self.orelse = orelse

    def render(self, ctx, out):
        seq = self.iter_expr(ctx)
        if isinstance(seq, Undefined):
            items = []
        elif isinstance(seq, dict):
            items = list(seq.keys())
        else:
            items = list(seq)
        inner = ctx.child()
        if self.cond is not None:
            filtered = []
            for it in items:
                self._bind(inner, it)
                if _is_true(self.cond(inner)):
                    filtered.append(it)
            items = filtered
        if not items:
            for n in self.orelse:
                n.render(ctx, out)
            return
        loop = _LoopVar(len(items), items)
        inner.set("loop", loop)
        for i, it in enumerate(items):
            loop.index0 = i
            self._bind(inner, it)
            try:
                for n in self.body:
                    n.render(inner, out)
            except _ContinueLoop:
                continue
            except _BreakLoop:
                break

    def _bind(self, ctx, item):
        if len(self.targets) == 1:
            ctx.set(self.targets[0], item)
        else:
            vals = list(item)
            if len(vals) != len(self.targets):
                raise TemplateError("cannot unpack loop target")
            for t, v in zip(self.targets, vals):
                ctx.set(t, v)


class _Set:
    __slots__ = ("target", "attr", "expr")

    def __init__(self, target, attr, expr):
        self.target = target
        self.attr = attr  # namespace attribute path or None
        self.expr = expr

    def render(self, ctx, out):
        v = self.expr(ctx)
        if self.attr is None:
            ctx.set(self.target, v)
        else:
            obj = ctx.lookup(self.target)
            for a in self.attr[:-1]:
                obj = _get_attr(obj, a)
            if isinstance(obj, Namespace):
                obj.__dict__[self.attr[-1]] = v
            elif isinstance(obj, dict):
                obj[self.attr[-1]] = v
            else:
                raise TemplateError(f"cannot assign attribute on {type(obj).__name__}")


class _SetBlock:
    __slots__ = ("target", "body", "filters")

    def __init__(self, target, body, filters):
        self.target = target
        self.body = body
        self.filters = filters  # [(name, argexprs, kwargexprs)]

    def render(self, ctx, out):
        sub = []
        for n in self.body:
            n.render(ctx, sub)
        v = "".join(sub)
        for fname, args, kwargs in self.filters:
            v = _apply_filter(fname, v, [a(ctx) for a in args],
                              {k: x(ctx) for k, x in kwargs.items()})
        ctx.set(self.target, v)


class _FilterBlock:
    __slots__ = ("filters", "body")

    def __init__(self, filters, body):
        self.filters = filters
        self.body = body

    def render(self, ctx, out):
        sub = []
        for n in self.body:
            n.render(ctx, sub)
        v = "".join(sub)
        for fname, args, kwargs in self.filters:
            v = _apply_filter(fname, v, [a(ctx) for a in args],
                              {k: x(ctx) for k, x in kwargs.items()})
        out.append(_to_text(v))


class _Break:
    def render(self, ctx, out):
        raise _BreakLoop


class _Continue:
    def render(self, ctx, out):
        raise _ContinueLoop


class Macro:
    __slots__ = ("name", "params", "defaults", "body", "scopes")

    def __init__(self, name, params, defaults, body, scopes):
        self.name = name
        self.params = params
        self.defaults = defaults  # name -> expr (evaluated at call time)
        self.body = body
        self.scopes = scopes  # live reference to definition scopes

    def __call__(self, *args, **kwargs):
        ctx = Context(self.scopes + [{}])
        for i, p in enumerate(self.params):
            if i < len(args):
                ctx.set(p, args[i])
            elif p in kwargs:
                ctx.set(p, kwargs[p])
            elif p in self.defaults:
                ctx.set(p, self.defaults[p](ctx))
            else:
                ctx.set(p, Undefined(p))
        out = []
        for n in self.body:
            n.render(ctx, out)
        # autoescape is OFF in the HF chat env, so macro results are plain
        # str (jinja2 wraps in Markup only under autoescape) — returning
        # Markup here would wrongly escape `str + macro_result` chains
        return "".join(out)


class _MacroDef:
    __slots__ = ("name", "params", "defaults", "body")

    def __init__(self, name, params, defaults, body):
        self.name = name
        self.params = params
        self.defaults = defaults
        self.body = body

    def render(self, ctx, out):
        ctx.set(self.name, Macro(self.name, self.params, self.defaults, self.body, ctx.scopes))


# ---------------------------------------------------------------------------
# Statement parser

_FOR_RE = re.compile(r"^for\s+(.+?)\s+in\s+(.+)$", re.S)


class _StmtParser:
    def __init__(self, parts):
        self.parts = parts
        self.i = 0

    def parse_body(self, until):
        """Parse until a stmt whose keyword is in `until`; returns (nodes, kw, rest)."""
        nodes = []
        while self.i < len(self.parts):
            kind, content = self.parts[self.i]
            self.i += 1
            if kind == "text":
                nodes.append(_Text(content))
                continue
            if kind == "expr":
                nodes.append(_Output(_parse_expr(content)))
                continue
            kw = content.split(None, 1)[0] if content else ""
            rest = content[len(kw):].strip()
            if kw in until:
                return nodes, kw, rest
            nodes.append(self.parse_stmt(kw, rest))
        if until:
            raise TemplateError(f"unexpected end of template (wanted one of {sorted(until)})")
        return nodes, None, None

    def parse_stmt(self, kw, rest):
        if kw == "if":
            branches = []
            cond = _parse_expr(rest)
            while True:
                body, term, trest = self.parse_body({"elif", "else", "endif"})
                branches.append((cond, body))
                if term == "elif":
                    cond = _parse_expr(trest)
                    continue
                if term == "else":
                    orelse, term2, _ = self.parse_body({"endif"})
                    return _If(branches, orelse)
                return _If(branches, [])
        if kw == "for":
            m = _FOR_RE.match(f"for {rest}")
            if not m:
                raise TemplateError(f"bad for statement: {rest!r}")
            target_src, iter_src = m.group(1), m.group(2)
            cond = None
            # optional trailing `if <cond>` filter (split at top level)
            iter_toks = _tokenize_expr(iter_src)
            depth = 0
            for ti, (tk, tv) in enumerate(iter_toks):
                if tk == "op" and tv in "([{":
                    depth += 1
                elif tk == "op" and tv in ")]}":
                    depth -= 1
                elif tk == "name" and tv == "if" and depth == 0:
                    p = _ExprParser(iter_toks[ti + 1:])
                    cond = p.parse()
                    iter_toks = iter_toks[:ti] + [("end", None)]
                    break
            p = _ExprParser(iter_toks)
            iter_expr = p.parse()
            targets = [t.strip() for t in target_src.strip("() ").split(",") if t.strip()]
            body, term, _ = self.parse_body({"else", "endfor"})
            orelse = []
            if term == "else":
                orelse, _, _ = self.parse_body({"endfor"})
            return _For(targets, iter_expr, cond, body, orelse)
        if kw == "set":
            if "=" in rest and not self._is_block_set(rest):
                tgt, expr_src = rest.split("=", 1)
                tgt = tgt.strip()
                if "." in tgt:
                    parts = tgt.split(".")
                    return _Set(parts[0], parts[1:], _parse_expr(expr_src))
                return _Set(tgt, None, _parse_expr(expr_src))
            # block form: {% set x [| filters] %}...{% endset %}
            fparts = [p.strip() for p in rest.split("|")]
            target = fparts[0]
            filters = [self._parse_filter_spec(fs) for fs in fparts[1:]]
            body, _, _ = self.parse_body({"endset"})
            return _SetBlock(target, body, filters)
        if kw == "macro":
            m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*\((.*)\)\s*$", rest, re.S)
            if not m:
                raise TemplateError(f"bad macro statement: {rest!r}")
            name = m.group(1)
            params, defaults = [], {}
            argsrc = m.group(2).strip()
            if argsrc:
                toks = _tokenize_expr(argsrc)
                p = _ExprParser(toks)
                while not p.done():
                    pk, pname = p.next()
                    if pk != "name":
                        raise TemplateError("bad macro parameter")
                    params.append(pname)
                    if p.at_op("="):
                        p.next()
                        defaults[pname] = p.parse()
                    if p.at_op(","):
                        p.next()
            body, _, _ = self.parse_body({"endmacro"})
            return _MacroDef(name, params, defaults, body)
        if kw == "filter":
            fparts = [p.strip() for p in rest.split("|")]
            filters = [self._parse_filter_spec(fs) for fs in fparts if fs]
            body, _, _ = self.parse_body({"endfilter"})
            return _FilterBlock(filters, body)
        if kw == "break":
            return _Break()
        if kw == "continue":
            return _Continue()
        if kw == "generation":
            # HF assistant-token tracker tag: render body transparently
            body, _, _ = self.parse_body({"endgeneration"})
            return _If([(lambda ctx: True, body)], [])
        raise TemplateError(f"unknown statement {kw!r}")

    @staticmethod
    def _is_block_set(rest):
        # `{% set x %}` (block) has no '='; `{% set x = y %}` is inline.
        # Handle `{% set x | trim %}` block form too.
        before_eq = rest.split("=", 1)[0]
        return "|" in before_eq and "=" not in rest.split("|", 1)[0]

    @staticmethod
    def _parse_filter_spec(src):
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*(\((.*)\))?\s*$", src, re.S)
        if not m:
            raise TemplateError(f"bad filter spec {src!r}")
        name = m.group(1)
        args, kwargs = [], {}
        if m.group(3):
            p = _ExprParser(_tokenize_expr(m.group(3) + ")"))
            args, kwargs = p._parse_call_args()
        return (name, args, kwargs)


# ---------------------------------------------------------------------------
# Public API


class Template:
    def __init__(self, source: str):
        parts = _lex(source)
        parser = _StmtParser(parts)
        self.nodes, _, _ = parser.parse_body(set())

    def render(self, variables: dict | None = None, *, now: datetime | None = None) -> str:
        def strftime_now(fmt):
            return (now or datetime.now()).strftime(fmt)

        def raise_exception(message):
            raise TemplateError(str(message))

        globals_ = {
            "range": range,
            "dict": dict,
            "namespace": Namespace,
            "raise_exception": raise_exception,
            "strftime_now": strftime_now,
            "tojson": _f_tojson,
        }
        ctx = Context([globals_, dict(variables or {})])
        out = []
        try:
            for n in self.nodes:
                n.render(ctx, out)
        except TemplateError:
            raise
        except Exception as e:
            # Python-level evaluation errors (iterating None, str+dict, ...)
            # surface as TemplateError so callers get one sandboxed failure
            # type — matching jinja2, which raises for these inputs too.
            raise TemplateError(f"{type(e).__name__}: {e}") from e
        return "".join(out)


def render(source: str, variables: dict | None = None, *, now: datetime | None = None) -> str:
    return Template(source).render(variables, now=now)
