"""GBNF (GGML BNF) grammar engine — constrained decoding.

Behavioral parity with src/llama-grammar.cpp: parse GBNF text into rules of
alternates of elements (char ranges, literals, rule refs, repetition
expanded into auxiliary rules exactly like llama_grammar_parser does), then
run a pushdown recognizer over UTF-8 text maintaining the SET of possible
stacks (the grammar may be locally ambiguous).

Elements:
  ("char", ((lo, hi), ...))          inclusive codepoint ranges
  ("not_char", ((lo, hi), ...))      negated ranges
  ("ref", rule_id)
A rule is a list of alternates; an alternate is a tuple of elements.
"""

from __future__ import annotations

from dataclasses import dataclass


class GrammarParseError(ValueError):
    pass


@dataclass
class Grammar:
    rules: list[list[tuple]]  # rule_id -> alternates -> tuple of elements
    names: dict[str, int]
    root: int = 0

    # ------------------------------------------------------------------
    # pushdown recognizer. A stack is a tuple of (rule_id, alt_id, pos)
    # frames; the top frame's current element is what must match next.

    def start_stacks(self) -> frozenset:
        return self._expand(((self.root, None, 0),))

    def _expand(self, stack: tuple) -> frozenset:
        """Expand rule refs until every stack's next element is a char
        matcher (or the stack is empty = accept state)."""
        out = set()
        self._expand_into(stack, out, 0)
        return frozenset(out)

    def _expand_into(self, stack: tuple, out: set, depth: int):
        if depth > 256:
            raise GrammarParseError("grammar recursion too deep (left recursion?)")
        if not stack:
            out.add(())
            return
        rule_id, alt_id, pos = stack[-1]
        if alt_id is None:
            # entering a rule: branch into each alternate
            for a, alt in enumerate(self.rules[rule_id]):
                self._expand_into(stack[:-1] + ((rule_id, a, 0),), out, depth + 1)
            return
        alt = self.rules[rule_id][alt_id]
        if pos >= len(alt):
            # rule finished: pop, advance caller
            below = stack[:-1]
            if not below:
                out.add(())
                return
            r2, a2, p2 = below[-1]
            self._expand_into(below[:-1] + ((r2, a2, p2 + 1),), out, depth + 1)
            return
        el = alt[pos]
        if el[0] == "ref":
            self._expand_into(stack + ((el[1], None, 0),), out, depth + 1)
        else:
            out.add(stack)

    @staticmethod
    def _el_matches(el: tuple, ch: int) -> bool:
        kind, ranges = el
        hit = any(lo <= ch <= hi for lo, hi in ranges)
        return hit if kind == "char" else not hit

    def accept_char(self, stacks: frozenset, ch: int) -> frozenset:
        out = set()
        for stack in stacks:
            if not stack:
                continue  # completed stacks can't consume more
            rule_id, alt_id, pos = stack[-1]
            el = self.rules[rule_id][alt_id][pos]
            if self._el_matches(el, ch):
                out |= self._expand(stack[:-1] + ((rule_id, alt_id, pos + 1),))
        return frozenset(out)

    def accept_text(self, stacks: frozenset, text: str) -> frozenset:
        for ch in text:
            stacks = self.accept_char(stacks, ord(ch))
            if not stacks:
                return stacks
        return stacks

    def can_accept_text(self, stacks: frozenset, text: str) -> bool:
        return bool(self.accept_text(stacks, text)) if text else True

    @staticmethod
    def is_complete(stacks: frozenset) -> bool:
        return () in stacks


# ---------------------------------------------------------------------------
# parser


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.names: dict[str, int] = {}
        self.rules: list[list[tuple] | None] = []

    def _rule_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.rules)
            self.rules.append(None)
        return self.names[name]

    def _new_aux(self, base: str) -> int:
        n = 0
        while f"{base}_{n}" in self.names:
            n += 1
        return self._rule_id(f"{base}_{n}")

    # --- lexing helpers ---
    def _ws(self):
        while self.i < len(self.src):
            c = self.src[self.i]
            if c == "#":
                while self.i < len(self.src) and self.src[self.i] != "\n":
                    self.i += 1
            elif c in " \t":
                self.i += 1
            else:
                break

    def _ws_nl(self):
        while self.i < len(self.src):
            c = self.src[self.i]
            if c == "#":
                while self.i < len(self.src) and self.src[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r\n":
                self.i += 1
            else:
                break

    def _name(self) -> str:
        j = self.i
        while j < len(self.src) and (self.src[j].isalnum() or self.src[j] in "-_"):
            j += 1
        if j == self.i:
            raise GrammarParseError(f"expected name at {self.i}: {self.src[self.i:self.i+20]!r}")
        name = self.src[self.i : j]
        self.i = j
        return name

    def _char_escape(self) -> int:
        c = self.src[self.i]
        self.i += 1
        if c != "\\":
            return ord(c)
        e = self.src[self.i]
        self.i += 1
        table = {"n": 10, "t": 9, "r": 13, '"': 34, "[": 91, "]": 93, "\\": 92,
                 "-": 45, "'": 39, "/": 47}
        if e in table:
            return table[e]
        if e == "x":
            v = int(self.src[self.i : self.i + 2], 16)
            self.i += 2
            return v
        if e == "u":
            v = int(self.src[self.i : self.i + 4], 16)
            self.i += 4
            return v
        if e == "U":
            v = int(self.src[self.i : self.i + 8], 16)
            self.i += 8
            return v
        raise GrammarParseError(f"bad escape \\{e}")

    # --- grammar of grammars ---
    def parse(self) -> Grammar:
        self._ws_nl()
        while self.i < len(self.src):
            self._rule()
            self._ws_nl()
        for name, rid in self.names.items():
            if self.rules[rid] is None:
                raise GrammarParseError(f"undefined rule {name!r}")
        if "root" not in self.names:
            raise GrammarParseError("no root rule")
        return Grammar(rules=self.rules, names=self.names, root=self.names["root"])

    def _rule(self):
        name = self._name()
        rid = self._rule_id(name)
        self._ws()
        if self.src[self.i : self.i + 3] == "::=":
            self.i += 3
        else:
            raise GrammarParseError(f"expected ::= after {name}")
        self._ws()
        alts = self._alternates(name)
        if self.rules[rid] is not None:
            raise GrammarParseError(f"duplicate rule {name}")
        self.rules[rid] = alts

    def _alternates(self, base: str) -> list[tuple]:
        alts = [self._sequence(base)]
        self._ws()
        while self.i < len(self.src) and self.src[self.i] == "|":
            self.i += 1
            self._ws()
            alts.append(self._sequence(base))
            self._ws()
        return alts

    def _sequence(self, base: str) -> tuple:
        seq: list[tuple] = []
        while True:
            self._ws()
            if self.i >= len(self.src):
                break
            c = self.src[self.i]
            if c in "|)\n\r":
                break
            el = self._element(base)
            if el is None:
                break
            # repetition suffix
            self._ws()
            if self.i < len(self.src) and self.src[self.i] in "*+?{":
                el = self._repeat(base, el)
            seq.extend(el if isinstance(el, list) else [el])
        return tuple(seq)

    def _element(self, base: str):
        c = self.src[self.i]
        if c == '"':
            self.i += 1
            out = []
            while self.src[self.i] != '"':
                cp = self._char_escape()
                out.append(("char", ((cp, cp),)))
            self.i += 1
            return out
        if c == "[":
            self.i += 1
            negate = self.src[self.i] == "^"
            if negate:
                self.i += 1
            ranges = []
            while self.src[self.i] != "]":
                lo = self._char_escape()
                if self.src[self.i] == "-" and self.src[self.i + 1] != "]":
                    self.i += 1
                    hi = self._char_escape()
                else:
                    hi = lo
                ranges.append((lo, hi))
            self.i += 1
            return ("not_char" if negate else "char", tuple(ranges))
        if c == "(":
            self.i += 1
            aux = self._new_aux(base)
            alts = self._alternates(base)
            self._ws_nl()
            if self.src[self.i] != ")":
                raise GrammarParseError(f"expected ) at {self.i}")
            self.i += 1
            self.rules[aux] = alts
            return ("ref", aux)
        if c.isalnum() or c in "-_":
            name = self._name()
            return ("ref", self._rule_id(name))
        raise GrammarParseError(f"unexpected char {c!r} at {self.i}")

    def _repeat(self, base: str, el):
        """Expand e*, e+, e?, e{m,n} into auxiliary rules (as the reference
        parser does)."""
        items = el if isinstance(el, list) else [el]
        op = self.src[self.i]
        self.i += 1
        if op == "*":
            aux = self._new_aux(base)
            self.rules[aux] = [tuple(items) + (("ref", aux),), ()]
            return [("ref", aux)]
        if op == "+":
            aux = self._new_aux(base)
            self.rules[aux] = [tuple(items) + (("ref", aux),), tuple(items)]
            return [("ref", aux)]
        if op == "?":
            aux = self._new_aux(base)
            self.rules[aux] = [tuple(items), ()]
            return [("ref", aux)]
        # {m}, {m,}, {m,n}
        j = self.src.index("}", self.i)
        spec = self.src[self.i : j]
        self.i = j + 1
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            m = int(lo_s) if lo_s else 0
            n = int(hi_s) if hi_s.strip() else None
        else:
            m = n = int(spec)
        out: list[tuple] = []
        for _ in range(m):
            out.extend(items)
        if n is None:
            aux = self._new_aux(base)
            self.rules[aux] = [tuple(items) + (("ref", aux),), ()]
            out.append(("ref", aux))
        else:
            for _ in range(n - m):
                aux = self._new_aux(base)
                self.rules[aux] = [tuple(items), ()]
                out.append(("ref", aux))
        return out


def parse_gbnf(src: str) -> Grammar:
    return _Parser(src).parse()
