"""Incremental / partial JSON parsing for streamed tool calls.

Analogue of the reference's healing-marker parser (reference:
common/json-partial.cpp:1-324 — `common_json_parse` closes truncated JSON so
a prefix of a streamed tool call can be inspected mid-generation). Design
here: a single token-walk records the open container stack and whether the
tail is inside a string/number/keyword, then `loads_partial` heals the text
(close the string, drop a dangling key or comma, close the containers) and
hands it to ``json.loads``.

Host-side code — no JAX involvement.
"""

from __future__ import annotations

import json
import re

__all__ = ["scan_json", "loads_partial", "PartialJson"]

_WS = " \t\r\n"
_NUM_TAIL = re.compile(r"[0-9eE+\-.]*")


def scan_json(s: str, pos: int = 0):
    """Walk one JSON value starting at `pos` (after leading whitespace).

    Returns ``(end, complete, state)``:
      * end: index one past the value (or len(s) when truncated)
      * complete: the value closed properly
      * state: dict with the open-container `stack` ('{'/'['), `in_string`,
        `in_key` (string currently being a dict key), `after_key` (saw key,
        waiting for ':'), `esc` (dangling backslash) — enough to heal.
    """
    n = len(s)
    i = pos
    while i < n and s[i] in _WS:
        i += 1
    stack: list[str] = []
    in_string = False
    in_key = False
    esc = False
    # expecting: 'value' | 'key' | 'colon' | 'comma_or_close'
    expect = "value"
    start = i
    while i < n:
        c = s[i]
        if in_string:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_string = False
                if in_key:
                    in_key = False
                    expect = "colon"
                else:
                    expect = "comma_or_close"
                    if not stack:
                        return i + 1, True, _state(stack, False, False, False, False)
            i += 1
            continue
        if c in _WS:
            i += 1
            continue
        if expect in ("value", "key"):
            if c == '"':
                in_string = True
                in_key = expect == "key"
                i += 1
                continue
            if expect == "key":
                if c == "}":  # empty object
                    stack.pop()
                    expect = "comma_or_close"
                    if not stack:
                        return i + 1, True, _state(stack, False, False, False, False)
                    i += 1
                    continue
                return i, False, _state(stack, False, False, False, False)
            if c == "{":
                stack.append("{")
                expect = "key"
                i += 1
                continue
            if c == "[":
                stack.append("[")
                expect = "value"
                i += 1
                continue
            if c == "]" and stack and stack[-1] == "[":  # empty array
                stack.pop()
                expect = "comma_or_close"
                if not stack:
                    return i + 1, True, _state(stack, False, False, False, False)
                i += 1
                continue
            if s.startswith(("true", "false", "null"), i):
                kw = next(k for k in ("true", "false", "null")
                          if s.startswith(k, i))
                i += len(kw)
                expect = "comma_or_close"
                if not stack:
                    return i, True, _state(stack, False, False, False, False)
                continue
            if any(s.startswith(k[: n - i], i) and n - i < len(k)
                   for k in ("true", "false", "null")):
                # truncated keyword tail
                return n, False, _state(stack, False, False, False, True)
            if c in "-0123456789":
                m = _NUM_TAIL.match(s, i + 1)
                i = m.end()
                expect = "comma_or_close"
                if i >= n:
                    # number may continue in the next chunk
                    st = _state(stack, False, False, False, False)
                    st["in_number"] = True
                    return n, not stack, st
                if not stack:
                    return i, True, _state(stack, False, False, False, False)
                continue
            return i, False, _state(stack, False, False, False, False)
        if expect == "colon":
            if c == ":":
                expect = "value"
                i += 1
                continue
            return i, False, _state(stack, False, False, False, False)
        # comma_or_close
        if c == ",":
            expect = "key" if (stack and stack[-1] == "{") else "value"
            i += 1
            continue
        if c == "}" and stack and stack[-1] == "{":
            stack.pop()
            expect = "comma_or_close"
            if not stack:
                return i + 1, True, _state(stack, False, False, False, False)
            i += 1
            continue
        if c == "]" and stack and stack[-1] == "[":
            stack.pop()
            expect = "comma_or_close"
            if not stack:
                return i + 1, True, _state(stack, False, False, False, False)
            i += 1
            continue
        return i, False, _state(stack, False, False, False, False)
    # truncated
    st = _state(stack, in_string, in_key, esc, False)
    st["expect"] = expect
    st["empty"] = i == start
    return n, False, st


def _state(stack, in_string, in_key, esc, in_keyword):
    return {
        "stack": list(stack),
        "in_string": in_string,
        "in_key": in_key,
        "esc": esc,
        "in_keyword": in_keyword,
        "expect": None,
        "empty": False,
    }


def loads_partial(s: str, pos: int = 0):
    """Parse a possibly-truncated JSON value.

    Returns ``(value, end, complete)``. For truncated input the text is
    healed (dangling escapes/strings closed, half-written keys and commas
    dropped, containers closed) and parsed, mirroring
    common/json-partial.cpp's healing marker strategy. Raises ValueError
    when even the healed prefix is not valid JSON (i.e. the text does not
    start a JSON value at all).
    """
    end, complete, st = scan_json(s, pos)
    frag = s[pos:end]
    if complete:
        return json.loads(frag), end, True
    if st.get("empty") or not frag.strip():
        raise ValueError("no JSON value")
    healed = frag
    if st.get("in_keyword"):
        # truncated true/false/null tail: drop it
        healed = re.sub(r"(?:t|tr|tru|f|fa|fal|fals|n|nu|nul)\s*$", "null",
                        healed)
    if st["esc"]:
        healed = healed[:-1]
    if st["in_string"]:
        healed += '"'
        if st["in_key"]:
            healed += ": null"
    elif st["in_key"] is False and st["stack"] and st["stack"][-1] == "{":
        # inside an object but not in a string: we may sit after a key
        # (expect colon/value) or after a comma (expect key) — strip back
        # to the last complete member
        healed = _strip_dangling_member(healed)
    healed = healed.rstrip()
    if healed.endswith((",", ":")):
        healed = healed[:-1].rstrip()
        if healed.endswith('"') and st["stack"] and st["stack"][-1] == "{":
            healed = _strip_dangling_member(healed)
    for c in reversed(st["stack"]):
        healed += "}" if c == "{" else "]"
    try:
        return json.loads(healed), end, False
    except json.JSONDecodeError:
        # second-chance: drop one trailing member and retry
        healed2 = _strip_dangling_member(s[pos:end]).rstrip().rstrip(",")
        for c in reversed(st["stack"]):
            healed2 += "}" if c == "{" else "]"
        return json.loads(healed2), end, False


def _strip_dangling_member(frag: str) -> str:
    """Remove a trailing `"key"` / `"key":` / `"key": <partial>` that has no
    complete value yet, so the healed object parses."""
    t = frag.rstrip()
    # trailing `"key"` or `"key":` with nothing (or whitespace) after
    m = re.search(r',?\s*"(?:[^"\\]|\\.)*"\s*:?\s*$', t)
    if m:
        return t[: m.start()]
    return frag


class PartialJson:
    """Stateful convenience wrapper: feed growing text, read latest value."""

    def __init__(self):
        self.text = ""

    def push(self, delta: str):
        self.text += delta

    def value(self, pos: int = 0):
        return loads_partial(self.text, pos)
