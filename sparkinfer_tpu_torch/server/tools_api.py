"""Tool/function calling for chat completions (parity: common/chat.cpp +
chat-parser — tool schema injection and tool-call extraction).

Strategy (the reference's generic path): inject tool schemas into the
system prompt with instructions to answer in a `<tool_call>{json}</tool_call>`
envelope (hermes-style, the most widely trained format), optionally
grammar-constrain the output to valid JSON, and parse the envelope (or a
bare JSON object with name/arguments) into OpenAI `tool_calls` entries.
"""

from __future__ import annotations

import json
import re
import uuid

TOOL_SYS_TEMPLATE = """You have access to the following tools, described by JSON schemas:

{tools}

To call a tool, reply with exactly:
<tool_call>
{{"name": "<tool-name>", "arguments": {{...}}}}
</tool_call>
Otherwise reply normally."""


def inject_tools(messages: list[dict], tools: list[dict]) -> list[dict]:
    """Prepend/extend the system message with tool schemas."""
    schemas = json.dumps(
        [t.get("function", t) for t in tools], indent=1
    )
    sys_text = TOOL_SYS_TEMPLATE.format(tools=schemas)
    out = list(messages)
    if out and out[0].get("role") == "system":
        out[0] = {"role": "system", "content": out[0]["content"] + "\n\n" + sys_text}
    else:
        out.insert(0, {"role": "system", "content": sys_text})
    return out


_TOOL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """Returns (content_without_calls, tool_calls list in OpenAI shape)."""
    calls = []
    for m in _TOOL_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        if "name" not in obj:
            continue
        calls.append({
            "id": f"call_{uuid.uuid4().hex[:12]}",
            "type": "function",
            "function": {
                "name": obj["name"],
                "arguments": json.dumps(obj.get("arguments", {})),
            },
        })
    content = _TOOL_RE.sub("", text).strip()
    if not calls:
        # bare-JSON fallback: whole message is {"name": ..., "arguments": ...}
        stripped = text.strip()
        if stripped.startswith("{"):
            try:
                obj = json.loads(stripped)
                if "name" in obj and "arguments" in obj:
                    calls.append({
                        "id": f"call_{uuid.uuid4().hex[:12]}",
                        "type": "function",
                        "function": {
                            "name": obj["name"],
                            "arguments": json.dumps(obj["arguments"]),
                        },
                    })
                    content = ""
            except json.JSONDecodeError:
                pass
    return content, calls


def tool_call_grammar(tools: list[dict], fmt: str = "hermes") -> str:
    """GBNF forcing a valid tool call for one of the given tools in the
    given format (used when tool_choice == 'required'). The grammar MUST
    emit what the corresponding chat_parser format parses (reference pairs
    grammars with formats the same way, common/chat.cpp per-format
    `data.grammar` blocks)."""
    from ..grammar.json_schema import json_schema_to_gbnf

    names = " | ".join(
        f'"\\"{t.get("function", t)["name"]}\\""' for t in tools
    )
    # accept any JSON object for arguments (schema-specific tightening is
    # possible per-tool; keep the arguments open like the reference default)
    base = json_schema_to_gbnf({})
    base = base.replace("root ::= space value", "jsonval ::= space value")
    def call_obj(argkey):
        return (
            '"{" space "\\"name\\"" space ":" space '
            f"({names}) space \",\" space \"\\\"{argkey}\\\"\" space \":\" "
            'jsonval "}"'
        )

    if fmt in ("llama3", "llama3-builtin"):
        root = "root ::= " + call_obj("parameters") + " space\n"
    elif fmt == "mistral-nemo":
        inner = call_obj("arguments")
        root = (f'root ::= "[TOOL_CALLS]" space "[" space {inner} '
                f'(space "," space {inner})* space "]" space\n')
    elif fmt == "command-r7b":
        inner = (
            '"{" space "\\"tool_call_id\\"" space ":" space string space '
            '"," space "\\"tool_name\\"" space ":" space '
            f"({names}) space \",\" space \"\\\"parameters\\\"\" space "
            '":" jsonval "}"'
        )
        root = (f'root ::= "<|START_ACTION|>" space "[" space {inner} '
                f'(space "," space {inner})* space "]" space '
                '"<|END_ACTION|>" space\n')
    else:  # hermes (default) / generic
        inner = call_obj("arguments")
        root = (f'root ::= "<tool_call>" space {inner} space '
                '"</tool_call>" space\n')
    return root + base
