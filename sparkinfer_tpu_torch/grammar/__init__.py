from .gbnf import Grammar, GrammarParseError, parse_gbnf
from .sampler import GrammarSampler
from .json_schema import json_schema_to_gbnf

__all__ = [
    "Grammar",
    "GrammarParseError",
    "parse_gbnf",
    "GrammarSampler",
    "json_schema_to_gbnf",
]
