"""JSON-schema -> GBNF converter (ref: common/json-schema-to-grammar.cpp).

Covers the practically-used subset: object (properties/required/
additionalProperties=false), array (items/minItems/maxItems), string
(enum/const), number/integer/boolean/null, oneOf/anyOf, $defs/$ref.
Used by the server's structured-output (response_format json_schema).
"""

from __future__ import annotations

import json

_PRIMS = {
    # bounded whitespace (ref json grammar bounds it too — unbounded space
    # lets degenerate models emit whitespace forever under constraint)
    "space": r'space ::= [ \t\n]{0,4}',
    "string": r'string ::= "\"" ([^"\\] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4}))* "\"" space',
    "number": r'number ::= "-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": r'integer ::= "-"? ([0-9] | [1-9] [0-9]*) space',
    "boolean": r'boolean ::= ("true" | "false") space',
    "null": r'null ::= "null" space',
    "value": r'value ::= object | array | string | number | boolean | null',
    "object": r'object ::= "{" space (objpair ("," space objpair)*)? "}" space',
    "objpair": r'objpair ::= string ":" space value',
    "array": r'array ::= "[" space (value ("," space value)*)? "]" space',
}


def _lit(s: str) -> str:
    esc = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{esc}"'


class _Conv:
    def __init__(self, defs: dict):
        self.rules: dict[str, str] = {"space": _PRIMS["space"]}
        self.defs = defs
        self.n = 0

    def need(self, name: str):
        if name not in self.rules:
            self.rules[name] = _PRIMS[name]
            # pull in transitive prims
            for dep in ("string", "number", "value", "object", "objpair",
                        "array", "boolean", "null"):
                if dep != name and f" {dep} " in f" {_PRIMS[name]} " or f"| {dep}" in _PRIMS[name]:
                    self.need(dep)

    def fresh(self, base: str) -> str:
        self.n += 1
        return f"{base}{self.n}"

    def visit(self, schema: dict, name: str) -> str:
        """Returns a rule NAME for this schema."""
        if "$ref" in schema:
            ref = schema["$ref"]
            key = ref.split("/")[-1]
            rn = f"def-{key}"
            if rn not in self.rules:
                self.rules[rn] = None  # placeholder for recursion
                body = self.visit(self.defs[key], self.fresh("d"))
                self.rules[rn] = f"{rn} ::= {body}"
            return rn
        for comb in ("oneOf", "anyOf"):
            if comb in schema:
                alts = [self.visit(s, self.fresh(name)) for s in schema[comb]]
                rn = self.fresh(name)
                self.rules[rn] = f"{rn} ::= " + " | ".join(alts)
                return rn
        if "enum" in schema:
            alts = " | ".join(_lit(json.dumps(v)) for v in schema["enum"])
            rn = self.fresh(name)
            self.rules[rn] = f"{rn} ::= ({alts}) space"
            return rn
        if "const" in schema:
            rn = self.fresh(name)
            self.rules[rn] = f"{rn} ::= {_lit(json.dumps(schema['const']))} space"
            return rn
        t = schema.get("type")
        if t == "object" and "properties" in schema:
            props = schema["properties"]
            required = set(schema.get("required", props.keys()))
            parts = ['"{" space']
            first = True
            for key, sub in props.items():
                sub_rule = self.visit(sub, self.fresh(name))
                pair = f'{_lit(json.dumps(key))} space ":" space {sub_rule}'
                if key not in required:
                    pair = f"({('' if first else chr(34)+','+chr(34)+' space ')}{pair})?"
                else:
                    if not first:
                        pair = f'"," space {pair}'
                parts.append(pair)
                first = False
            parts.append('"}" space')
            rn = self.fresh(name)
            self.rules[rn] = f"{rn} ::= " + " ".join(parts)
            return rn
        if t == "array":
            item = self.visit(schema.get("items", {}), self.fresh(name))
            rn = self.fresh(name)
            min_i = schema.get("minItems", 0)
            if min_i == 0:
                self.rules[rn] = f'{rn} ::= "[" space ({item} ("," space {item})*)? "]" space'
            else:
                reps = " ".join([item] + [f'"," space {item}'] * (min_i - 1))
                self.rules[rn] = f'{rn} ::= "[" space {reps} ("," space {item})* "]" space'
            return rn
        if t in ("string", "number", "integer", "boolean", "null"):
            self.need(t)
            return t
        # untyped: any JSON value
        for p in ("value", "object", "objpair", "array", "string", "number",
                  "boolean", "null"):
            self.need(p)
        return "value"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    defs = schema.get("$defs", schema.get("definitions", {}))
    c = _Conv(defs)
    root_body = c.visit(schema, "r")
    lines = [f"root ::= space {root_body}"]
    for name, rule in c.rules.items():
        if rule is not None:
            lines.append(rule)
    return "\n".join(lines)
