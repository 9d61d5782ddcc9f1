"""Multi-format tool-call parsing with incremental (streaming) support.

Analogue of the reference's chat parser stack (reference:
common/chat-parser.cpp:680-1450 — per-format extractors over a builder with
partial-input semantics; common/chat.cpp common_chat_msg_diff — successive
parses diffed into OpenAI streaming deltas).

Design notes (differs from the reference on purpose):
  * Each update re-parses the full accumulated text (messages are KBs; the
    reference does the same full reparse per token under the hood).
  * Tool-call `arguments` are RAW SOURCE SLICES of the model's own JSON —
    monotone under growth, so streamed argument deltas concatenate to
    exactly the final arguments string (the reference re-dumps healed JSON
    and truncates at a healing marker to get the same monotonicity).
  * Reasoning blocks (<think>, <|START_THINKING|>, [THINK]) are split into
    `reasoning` like the reference's try_parse_reasoning.

Formats: content, hermes, llama3, llama3-builtin, mistral-nemo,
command-r7b, deepseek-r1, generic.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field

from .json_partial import loads_partial, scan_json

__all__ = ["ChatMsg", "ToolCall", "parse_chat", "detect_format",
           "StreamParser", "to_openai_tool_calls"]


def to_openai_tool_calls(msg: "ChatMsg") -> list[dict]:
    return [{
        "id": tc.id,
        "type": "function",
        "function": {"name": tc.name, "arguments": tc.arguments or "{}"},
    } for tc in msg.tool_calls]


@dataclass
class ToolCall:
    name: str = ""
    arguments: str = ""  # raw JSON text (possibly a partial prefix)
    id: str = ""
    complete: bool = False


@dataclass
class ChatMsg:
    content: str = ""
    reasoning: str = ""
    tool_calls: list = field(default_factory=list)
    partial: bool = False  # parse ended mid-structure; wait for more text


# ---------------------------------------------------------------------------
# helpers

_WS = " \t\r\n"


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in _WS:
        i += 1
    return i


def _iter_members(s: str, i: int):
    """Yield (key, value_start, value_end, complete) for the object whose
    '{' is at s[i]; stops at truncation. Final yield may be incomplete."""
    n = len(s)
    assert s[i] == "{"
    i = _skip_ws(s, i + 1)
    while i < n:
        if s[i] == "}":
            return
        if s[i] != '"':
            return
        # parse the key string
        kend, complete, st = scan_json(s, i)
        if not complete:
            return
        key = json.loads(s[i:kend])
        i = _skip_ws(s, kend)
        if i >= n or s[i] != ":":
            return
        i = _skip_ws(s, i + 1)
        if i >= n:
            return
        vend, vcomplete, _ = scan_json(s, i)
        yield key, i, vend, vcomplete
        if not vcomplete:
            return
        i = _skip_ws(s, vend)
        if i < n and s[i] == ",":
            i = _skip_ws(s, i + 1)
        elif i < n and s[i] == "}":
            return


def _hold_marker_tail(text: str, markers) -> tuple[str, str]:
    """Split text so a trailing prefix of any marker is withheld (the
    reference's partial-regex-at-end behavior): returns (emit, held)."""
    for m in markers:
        for k in range(min(len(m) - 1, len(text)), 0, -1):
            if text.endswith(m[:k]):
                return text[:-k], text[-k:]
    return text, ""


def _new_id() -> str:
    return f"call_{uuid.uuid4().hex[:12]}"


def _reasoning_split(text: str, open_tag: str, close_tag: str,
                     partial: bool,
                     forced_open: bool = False) -> tuple[str, str, bool]:
    """-> (reasoning, rest, still_inside). Mirrors try_parse_reasoning:
    an unclosed block while partial means everything after open is
    reasoning-in-progress. forced_open: the template already emitted the
    opening tag, so the message STARTS inside the block (reference
    thinking_forced_open; an unclosed forced block that is NOT partial
    demotes to content, test-chat-parser.cpp deepseek-v3.1 variants)."""
    stripped = text.lstrip()
    if forced_open and not stripped.startswith(open_tag):
        end = text.find(close_tag)
        if end < 0:
            if partial:
                inner, _held = _hold_marker_tail(text, (close_tag,))
                return inner, "", True
            return "", text, False  # fine-tuning slip: treat as content
        return text[:end], text[end + len(close_tag):], False
    if not stripped.startswith(open_tag):
        if partial and stripped and open_tag.startswith(stripped):
            # message so far is a prefix of the open tag — withhold
            return "", "", True
        # some models emit the body straight after an implicit opening tag;
        # only explicit blocks are extracted here
        return "", text, False
    off = len(text) - len(stripped)
    start = off + len(open_tag)
    end = text.find(close_tag, start)
    if end < 0:
        inner = text[start:]
        if partial:
            # withhold a trailing prefix of the close tag so it never
            # leaks into streamed reasoning deltas
            inner, _held = _hold_marker_tail(inner, (close_tag,))
        return inner, "", True
    return text[start:end], text[end + len(close_tag):], False


def _member_complete(src: str, obj_start: int, key: str) -> bool:
    """True when `key`'s VALUE is fully present in the object at obj_start
    (streaming gate: don't surface a tool call until its name finished)."""
    for k, _vs, _ve, comp in _iter_members(src, obj_start):
        if k == key:
            return comp
    return False


def _args_slice(src: str, obj_start: int, key: str,
                upto: int | None = None) -> tuple[str, bool]:
    """Raw text of the value for `key` in the object at obj_start.
    Returns (slice, complete); for truncated values the slice runs to the
    end of available text."""
    for k, vs, ve, comp in _iter_members(src, obj_start):
        if k == key:
            hi = ve if upto is None else min(ve, upto)
            return src[vs:hi], comp
    return "", False


# ---------------------------------------------------------------------------
# format parsers (full-text, partial-aware)


def _parse_hermes(text: str, partial: bool) -> ChatMsg:
    """<tool_call>{"name": ..., "arguments": {...}}</tool_call> blocks
    (reference: common_chat_parse_hermes_2_pro)."""
    msg = ChatMsg()
    OPEN, CLOSE = "<tool_call>", "</tool_call>"
    content_parts = []
    i = 0
    n = len(text)
    while True:
        j = text.find(OPEN, i)
        if j < 0:
            tail = text[i:]
            if partial:
                emit, held = _hold_marker_tail(tail, (OPEN,))
                content_parts.append(emit)
                msg.partial = bool(held)
            else:
                content_parts.append(tail)
            break
        content_parts.append(text[i:j])
        body = _skip_ws(text, j + len(OPEN))
        if body >= n:
            msg.partial = True
            break
        try:
            obj, end, comp = loads_partial(text, body)
        except ValueError:
            msg.partial = True
            break
        name = obj.get("name", "") if isinstance(obj, dict) else ""
        args, args_done = ("", False)
        if isinstance(obj, dict) and text[body] == "{":
            args, args_done = _args_slice(text, body, "arguments")
        tc = ToolCall(name=str(name), arguments=args, id=_new_id(),
                      complete=comp and args_done)
        close = text.find(CLOSE, end)
        if comp and close >= 0:
            tc.complete = True
            if not tc.arguments:
                tc.arguments = json.dumps(obj.get("arguments", {})) \
                    if isinstance(obj, dict) else "{}"
            msg.tool_calls.append(tc)
            i = close + len(CLOSE)
            continue
        # incomplete block: surface the in-progress call only once its
        # name has fully streamed (a healed half-name would stick — the
        # first delta a client sees for a call carries the name)
        if partial:
            if name and text[body] == "{" and \
                    _member_complete(text, body, "name"):
                msg.tool_calls.append(tc)
            msg.partial = True
        break
    msg.content = "".join(content_parts).strip()
    if not msg.tool_calls and not partial:
        _bare_json_fallback(text, msg)
    return msg


def _bare_json_fallback(text: str, msg: ChatMsg):
    """Whole message is {"name": ..., "arguments"|"parameters": ...}
    (reference generic handler, chat-parser.cpp:640-687)."""
    stripped = text.strip()
    if not stripped.startswith("{"):
        return
    try:
        obj = json.loads(stripped)
    except json.JSONDecodeError:
        return
    if isinstance(obj, dict) and "name" in obj and (
            "arguments" in obj or "parameters" in obj):
        args = obj.get("arguments", obj.get("parameters", {}))
        msg.tool_calls = [ToolCall(name=str(obj["name"]),
                                   arguments=json.dumps(args),
                                   id=_new_id(), complete=True)]
        msg.content = ""


def _parse_llama3(text: str, partial: bool,
                  builtin: bool = False) -> ChatMsg:
    """{"name": "f", "parameters": {...}} at message start; with
    builtin=True also <|python_tag|>f.call(a=1, ...) (reference:
    common_chat_parse_llama_3_1)."""
    reasoning, rest, inside = _reasoning_split(text, "<think>", "</think>",
                                               partial)
    msg = ChatMsg(reasoning=reasoning, partial=inside and partial)
    if inside:
        return msg
    body = rest.lstrip()
    off = len(rest) - len(body)
    if builtin and "<|python_tag|>" in body:
        pre, _, call = body.partition("<|python_tag|>")
        msg.content = pre.strip()
        m = re.match(r"\s*(\w+)\s*\.\s*call\(", call)
        if not m:
            msg.partial = partial
            return msg
        args = {}
        i = m.end()
        while True:
            am = re.match(r"\s*(\w+)\s*=\s*", call[i:])
            if not am:
                break
            try:
                v, vend, comp = loads_partial(call, i + am.end())
            except ValueError:
                msg.partial = True
                break
            if not comp:
                msg.partial = True
                break
            args[am.group(1)] = v
            i = vend
            cm = re.match(r"\s*,", call[i:])
            if not cm:
                break
            i += cm.end()
        done = re.match(r"\s*\)", call[i:]) is not None
        tc = ToolCall(name=m.group(1), arguments=json.dumps(args),
                      id=_new_id(), complete=done)
        if done or partial:
            msg.tool_calls.append(tc)
        msg.partial = msg.partial or not done
        return msg
    fm = re.match(
        r'\s*\{\s*(?:"type"\s*:\s*"function"\s*,\s*)?"name"\s*:\s*"([^"]+)"'
        r'\s*,\s*"parameters"\s*:\s*', body)
    if fm:
        obj_start = body.index("{")
        try:
            obj, end, comp = loads_partial(body, obj_start)
        except ValueError:
            comp = False
            obj = {}
        args, args_done = _args_slice(body, obj_start, "parameters")
        tc = ToolCall(name=fm.group(1), arguments=args, id=_new_id(),
                      complete=comp and args_done)
        if comp or partial:
            msg.tool_calls.append(tc)
        msg.partial = not comp
        if comp:
            msg.content = body[end:].strip()
        return msg
    if partial:
        if body.startswith("{"):
            # a leading JSON object may still become a function call once
            # `"parameters"` arrives — withhold until decidable (the
            # reference consumes the JSON first and decides after)
            msg.partial = True
            return msg
        emit, held = _hold_marker_tail(body, ('{"', "<|python_tag|>")
                                       if builtin else ('{"',))
        msg.content = emit.strip()
        msg.partial = bool(held)
    else:
        msg.content = body.strip()
    return msg


def _parse_mistral_nemo(text: str, partial: bool) -> ChatMsg:
    """[TOOL_CALLS][{"name": ..., "arguments": {...}, "id": ...}, ...]
    (reference: common_chat_parse_mistral_nemo)."""
    MARK = "[TOOL_CALLS]"
    j = text.find(MARK)
    if j < 0:
        msg = ChatMsg()
        if partial:
            emit, held = _hold_marker_tail(text, (MARK,))
            msg.content = emit.strip()
            msg.partial = bool(held)
        else:
            msg.content = text.strip()
        return msg
    msg = ChatMsg(content=text[:j].strip())
    i = _skip_ws(text, j + len(MARK))
    if i >= len(text) or text[i] != "[":
        msg.partial = True
        return msg
    # walk array elements
    n = len(text)
    i = _skip_ws(text, i + 1)
    while i < n and text[i] != "]":
        if text[i] != "{":
            break
        estart = i
        eend, ecomp, _ = scan_json(text, i)
        try:
            obj, _, _ = loads_partial(text, estart)
        except ValueError:
            obj = {}
        name = str(obj.get("name", "")) if isinstance(obj, dict) else ""
        args, args_done = _args_slice(text, estart, "arguments")
        cid = str(obj.get("id", "")) if isinstance(obj, dict) else ""
        tc = ToolCall(name=name, arguments=args, id=cid or _new_id(),
                      complete=ecomp and args_done)
        if ecomp:
            if not tc.arguments:
                tc.arguments = json.dumps(obj.get("arguments", {}))
                tc.complete = True
            msg.tool_calls.append(tc)
            i = _skip_ws(text, eend)
            if i < n and text[i] == ",":
                i = _skip_ws(text, i + 1)
            continue
        if partial and name and _member_complete(text, estart, "name"):
            msg.tool_calls.append(tc)
        msg.partial = True
        return msg
    msg.partial = i >= n
    return msg


def _parse_command_r7b(text: str, partial: bool) -> ChatMsg:
    """<|START_THINKING|>..<|END_THINKING|> + <|START_ACTION|>[{tool_name,
    parameters, tool_call_id}]<|END_ACTION|> or <|START_RESPONSE|>..
    (reference: common_chat_parse_command_r7b)."""
    reasoning, rest, inside = _reasoning_split(
        text, "<|START_THINKING|>", "<|END_THINKING|>", partial)
    msg = ChatMsg(reasoning=reasoning)
    if inside:
        msg.partial = True
        return msg
    a = rest.find("<|START_ACTION|>")
    r = rest.find("<|START_RESPONSE|>")
    if a >= 0:
        i = _skip_ws(rest, a + len("<|START_ACTION|>"))
        if i >= len(rest) or rest[i] != "[":
            msg.partial = True
            return msg
        n = len(rest)
        i = _skip_ws(rest, i + 1)
        while i < n and rest[i] != "]":
            if rest[i] != "{":
                break
            estart = i
            eend, ecomp, _ = scan_json(rest, i)
            try:
                obj, _, _ = loads_partial(rest, estart)
            except ValueError:
                obj = {}
            name = str(obj.get("tool_name", "")) if isinstance(obj, dict) else ""
            cid = str(obj.get("tool_call_id", "")) if isinstance(obj, dict) else ""
            args, args_done = _args_slice(rest, estart, "parameters")
            tc = ToolCall(name=name, arguments=args, id=cid or _new_id(),
                          complete=ecomp and args_done)
            if ecomp:
                if not tc.arguments:
                    tc.arguments = json.dumps(obj.get("parameters", {}))
                    tc.complete = True
                msg.tool_calls.append(tc)
                i = _skip_ws(rest, eend)
                if i < n and rest[i] == ",":
                    i = _skip_ws(rest, i + 1)
                continue
            if partial and name and \
                    _member_complete(rest, estart, "tool_name"):
                msg.tool_calls.append(tc)
            msg.partial = True
            return msg
        msg.partial = i >= n or "<|END_ACTION|>" not in rest[i:]
        return msg
    if r >= 0:
        start = r + len("<|START_RESPONSE|>")
        end = rest.find("<|END_RESPONSE|>", start)
        if end < 0:
            msg.content = rest[start:]
            msg.partial = partial
        else:
            msg.content = rest[start:end]
        return msg
    if partial:
        emit, held = _hold_marker_tail(
            rest, ("<|START_ACTION|>", "<|START_RESPONSE|>"))
        msg.content = emit.strip()
        msg.partial = bool(held)
    else:
        msg.content = rest.strip()
    return msg


def _parse_deepseek_v31(text: str, partial: bool,
                        thinking_open: bool = False) -> ChatMsg:
    """DeepSeek-V3.1: <｜tool▁call▁begin｜>NAME<｜tool▁sep｜>{json}
    <｜tool▁call▁end｜> (no `function` keyword, no ```json fences), with
    template-forced-open thinking (reference:
    common_chat_parse_deepseek_v3_1 + test-chat-parser.cpp variants)."""
    reasoning, rest, inside = _reasoning_split(
        text, "<think>", "</think>", partial, forced_open=thinking_open)
    msg = ChatMsg(reasoning=reasoning)
    if inside:
        msg.partial = True
        return msg
    begin = rest.find("<｜tool▁calls▁begin｜>")
    if begin < 0:
        if partial:
            emit, held = _hold_marker_tail(rest, ("<｜tool▁calls▁begin｜>",))
            msg.content = emit.strip()
            msg.partial = bool(held)
        else:
            msg.content = rest.strip()
        return msg
    msg.content = rest[:begin].strip()
    i = begin + len("<｜tool▁calls▁begin｜>")
    call_re = re.compile(r"<｜tool▁call▁begin｜>([^<]+?)<｜tool▁sep｜>")
    while True:
        cm = call_re.search(rest, i)
        if not cm:
            msg.partial = partial and "<｜tool▁calls▁end｜>" not in rest[i:]
            return msg
        jstart = _skip_ws(rest, cm.end())
        try:
            obj, jend, comp = loads_partial(rest, jstart)
        except ValueError:
            msg.partial = True
            return msg
        tc = ToolCall(name=cm.group(1).strip(),
                      arguments=rest[jstart:jend], id=_new_id(),
                      complete=comp)
        if comp:
            msg.tool_calls.append(tc)
            em = rest.find("<｜tool▁call▁end｜>", jend)
            i = em + len("<｜tool▁call▁end｜>") if em >= 0 else jend
            continue
        if partial and tc.name:
            msg.tool_calls.append(tc)
        msg.partial = True
        return msg


def _parse_deepseek_r1(text: str, partial: bool) -> ChatMsg:
    """<think>..</think> + <｜tool▁calls▁begin｜>function<｜tool▁sep｜>NAME
    \\n```json\\n{...}\\n```<｜tool▁call▁end｜> (reference:
    common_chat_parse_deepseek_r1)."""
    reasoning, rest, inside = _reasoning_split(text, "<think>", "</think>",
                                               partial)
    msg = ChatMsg(reasoning=reasoning)
    if inside:
        msg.partial = True
        return msg
    begin = re.search(
        r"<｜tool▁calls▁begin｜>|<｜tool_calls_begin｜>|<｜tool calls begin｜>"
        r"|<｜tool▁calls｜>", rest)
    if not begin:
        if partial:
            emit, held = _hold_marker_tail(rest, ("<｜tool▁calls▁begin｜>",))
            msg.content = emit.strip()
            msg.partial = bool(held)
        else:
            msg.content = rest.strip()
        return msg
    msg.content = rest[:begin.start()].strip()
    i = begin.end()
    func_re = re.compile(
        r"(?:<｜tool▁call▁begin｜>)?function<｜tool▁sep｜>([^\n]+)\n```json\n")
    close_re = re.compile(r"```[\s\r\n]*(?:<｜tool▁call▁end｜>)?")
    while True:
        fm = func_re.search(rest, i)
        if not fm:
            msg.partial = partial and "<｜tool▁calls▁end｜>" not in rest[i:]
            return msg
        jstart = fm.end()
        try:
            obj, jend, comp = loads_partial(rest, jstart)
        except ValueError:
            msg.partial = True
            return msg
        args = rest[jstart:jend]
        tc = ToolCall(name=fm.group(1).strip(), arguments=args,
                      id=_new_id(), complete=comp)
        if comp:
            msg.tool_calls.append(tc)
            cm = close_re.match(rest, _skip_ws(rest, jend))
            i = cm.end() if cm else jend
            continue
        if partial:
            msg.tool_calls.append(tc)
        msg.partial = True
        return msg


def _parse_generic(text: str, partial: bool) -> ChatMsg:
    """Bare-JSON generic format: {"tool_calls": [...]} / {"tool_call": {...}}
    / {"response": ...} (reference: common_chat_parse_generic)."""
    msg = ChatMsg()
    stripped = text.strip()
    if not stripped.startswith("{"):
        msg.content = stripped
        return msg
    try:
        obj, end, comp = loads_partial(stripped)
    except ValueError:
        msg.content = "" if partial else stripped
        msg.partial = partial
        return msg
    if not isinstance(obj, dict):
        msg.content = stripped
        return msg
    calls = obj.get("tool_calls")
    if calls is None and "tool_call" in obj:
        calls = [obj["tool_call"]]
    if calls:
        for c in calls:
            if not isinstance(c, dict) or "name" not in c:
                continue
            args = c.get("arguments", c.get("parameters", {}))
            msg.tool_calls.append(ToolCall(
                name=str(c["name"]),
                arguments=args if isinstance(args, str) else json.dumps(args),
                id=str(c.get("id", "")) or _new_id(), complete=comp))
        msg.partial = not comp
        return msg
    if "response" in obj:
        resp = obj["response"]
        msg.content = resp if isinstance(resp, str) else json.dumps(
            resp, ensure_ascii=False)
        msg.partial = not comp
        return msg
    msg.content = "" if partial else stripped
    msg.partial = partial
    return msg


_PARSERS = {
    "hermes": _parse_hermes,
    "llama3": lambda t, p: _parse_llama3(t, p),
    "llama3-builtin": lambda t, p: _parse_llama3(t, p, builtin=True),
    "mistral-nemo": _parse_mistral_nemo,
    "command-r7b": _parse_command_r7b,
    "deepseek-r1": _parse_deepseek_r1,
    "deepseek-v3.1": _parse_deepseek_v31,
    "generic": _parse_generic,
}


def parse_chat(text: str, fmt: str = "hermes",
               partial: bool = False, thinking_open: bool = False) -> ChatMsg:
    """Parse an assistant message in the given tool-call format.

    partial=True: the message is still streaming — incomplete trailing
    structures become in-progress tool calls / withheld content instead of
    plain text. thinking_open=True: the prompt ended with an opening
    <think>, so the message starts inside a reasoning block (reference
    thinking_forced_open; honored by formats with reasoning support).
    """
    if fmt == "content":
        return ChatMsg(content=text)
    p = _PARSERS.get(fmt)
    if p is None:
        raise ValueError(f"unknown chat format {fmt!r}")
    if fmt == "deepseek-v3.1":
        return p(text, partial, thinking_open=thinking_open)
    if thinking_open and fmt in ("deepseek-r1", "llama3",
                                 "llama3-builtin"):
        # close the forced-open block by reattaching the tag the template
        # consumed, so the explicit-block path handles it uniformly
        return p("<think>" + text, partial)
    return p(text, partial)


def detect_format(template_source: str | None,
                  family: str | None = None) -> str:
    """Pick the tool-call format from the chat template (the reference
    selects per-template in common_chat_templates_apply_jinja)."""
    src = template_source or ""
    if "[TOOL_CALLS]" in src:
        return "mistral-nemo"
    if "<|START_ACTION|>" in src:
        return "command-r7b"
    if "tool▁calls▁begin" in src or "tool▁sep" in src:
        # v3.1 emits NAME<｜tool▁sep｜>{json} directly; r1 wraps in
        # function<｜tool▁sep｜>NAME\n```json fences
        if "```json" in src or "function<｜tool▁sep｜>" in src:
            return "deepseek-r1"
        return "deepseek-v3.1"
    if "<tool_call>" in src:
        return "hermes"
    if "<|python_tag|>" in src:
        return "llama3-builtin"
    if "<|start_header_id|>" in src or family == "llama3":
        return "llama3"
    if family == "command-r":
        return "command-r7b"
    if family == "deepseek3":
        return "deepseek-r1"
    # our injected envelope instructs hermes style
    return "hermes"


# ---------------------------------------------------------------------------
# streaming diff


class StreamParser:
    """Feed text deltas, get OpenAI `choices[0].delta` dicts back.

    Mirrors the reference's update_chat_msg + common_chat_msg_diff loop
    (tools/server/server-task.cpp oaicompat path): each delta re-parses the
    accumulated text in partial mode and diffs against the previous parse.
    """

    def __init__(self, fmt: str = "hermes", thinking_open: bool = False):
        self.fmt = fmt
        self.thinking_open = thinking_open
        self.text = ""
        self.prev = ChatMsg()
        self._role_sent = False

    def update(self, delta_text: str, final: bool = False) -> list[dict]:
        self.text += delta_text
        cur = parse_chat(self.text, self.fmt, partial=not final,
                         thinking_open=self.thinking_open)
        out = self._diff(self.prev, cur)
        self.prev = cur
        return out

    def finish(self) -> list[dict]:
        return self.update("", final=True)

    @property
    def message(self) -> ChatMsg:
        return self.prev

    def _diff(self, prev: ChatMsg, cur: ChatMsg) -> list[dict]:
        deltas = []
        if cur.reasoning != prev.reasoning and \
                cur.reasoning.startswith(prev.reasoning):
            tail = cur.reasoning[len(prev.reasoning):]
            if tail:
                deltas.append({"reasoning_content": tail})
        if cur.content != prev.content:
            if cur.content.startswith(prev.content):
                tail = cur.content[len(prev.content):]
            else:  # non-monotone (e.g. strip() effects) — resend whole
                tail = cur.content
            if tail:
                deltas.append({"content": tail})
        for idx, tc in enumerate(cur.tool_calls):
            if idx >= len(prev.tool_calls):
                deltas.append({"tool_calls": [{
                    "index": idx, "id": tc.id, "type": "function",
                    "function": {"name": tc.name,
                                 "arguments": tc.arguments}}]})
                continue
            old = prev.tool_calls[idx]
            if tc.arguments != old.arguments:
                if tc.arguments.startswith(old.arguments):
                    tail = tc.arguments[len(old.arguments):]
                else:
                    tail = tc.arguments
                if tail:
                    deltas.append({"tool_calls": [{
                        "index": idx,
                        "function": {"arguments": tail}}]})
        return deltas
