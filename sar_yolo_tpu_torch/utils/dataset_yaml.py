"""A reader of the YAML subset that dataset and model files use (the training machine has
no YAML parser; the JAX package reads them with PyYAML's `safe_load`).

Read: `key: value` lines at any indentation (an indented block is the mapping of the
key above it), block sequences (`- item`), flow sequences `[a, b]` over one or more
lines, plain, single- and double-quoted scalars resolved as YAML 1.1 does (int, float,
bool, null, else str), and comments. Block scalars (`key: |` or `key: >`, such as a
`download:` script) are skipped whole, their key included. Anything else raises
ValueError.
"""

from __future__ import annotations

import re
from pathlib import Path

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_SPECIAL = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
            ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}


def _strip_comment(text: str) -> str:
    """`text` without a trailing ` # comment` outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def scalar(text: str):
    """A YAML 1.1 scalar: quoted string, null, bool, int, float or plain string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return text[1:-1].encode().decode("unicode_escape")
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL:
        return _SPECIAL[text]
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def _flow_items(text: str) -> list:
    """Items of a flow sequence `[a, 'b, c', [d]]`."""
    inner = text.strip()[1:-1]
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(inner + ","):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            item = inner[start:i].strip()
            if item:
                items.append(_flow_items(item) if item.startswith("[") else scalar(item))
            start = i + 1
    return items


def _value(text: str):
    return _flow_items(text) if text.startswith("[") else scalar(text)


def _split_key(text: str):
    """(key, rest) of a `key: rest` line, or None."""
    m = re.match(r"""('[^']*'|"[^"]*"|[^\s'"#][^:#]*?)\s*:(?:\s+|$)(.*)$""", text)
    if m is None:
        return None
    return scalar(m.group(1)), m.group(2)


def load_yaml(path) -> dict:
    """The mapping of a dataset or model YAML file; raises ValueError on a construct outside
    the subset."""
    lines = []  # (indent, text) of the lines that carry content
    raw = Path(path).read_text(encoding="utf-8", errors="ignore").splitlines()
    i = 0
    while i < len(raw):
        line = raw[i]
        text = _strip_comment(line)
        i += 1
        if not text.strip() or text.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        text = text.strip()
        if text.startswith("[") or (":" in text and _split_key(text) and
                                    _split_key(text)[1].startswith("[")):
            while text.count("[") > text.count("]") and i < len(raw):  # a flow sequence goes on
                text += " " + _strip_comment(raw[i]).strip()
                i += 1
        kv = _split_key(text)
        if kv and kv[1] and kv[1][0] in "|>":  # a block scalar: skip its indented lines
            while i < len(raw) and (not raw[i].strip() or
                                    len(raw[i]) - len(raw[i].lstrip(" ")) > indent):
                i += 1
            continue
        lines.append((indent, text))
    value, end = _block(lines, 0, lines[0][0] if lines else 0)
    if end != len(lines):
        raise ValueError(f"{path}: cannot read line '{lines[end][1]}'")
    return value or {}


def _block(lines: list, i: int, indent: int):
    """The mapping or sequence whose entries start at lines[i] with this indent; returns
    (value, index of the first line after it)."""
    if i >= len(lines):
        return None, i
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        seq = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("-"):
            seq.append(_value(lines[i][1][1:].strip()))
            i += 1
        return seq, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"not a key: value line: '{lines[i][1]}'")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or
                                 (lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i
