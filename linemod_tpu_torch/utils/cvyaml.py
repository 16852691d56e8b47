"""Parser for the OpenCV-FileStorage YAML subset the project's files use,
without PyYAML.

`parse_yaml` reads block mappings and block sequences, and flow mappings
and flow sequences that may run over many lines, into dicts, lists and
scalars (an integer, a float, a double-quoted string or a bare string).
`%YAML` directives, `---` and `#` comment lines are skipped, and an
`!!opencv-matrix` node is read as the mapping it tags.
`utils/yamlcv.read_yamlcv` builds the settings, model and pose files'
reader over it, and `utils/refformat` the reference's bank pair's.
"""

from __future__ import annotations

import re


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


# -- the block and flow subset ----------------------------------------------
#
# `linemod_templates.yml.gz` nests deeper than the settings files: block
# mappings and block sequences (`- key: value` items), and flow mappings and
# flow sequences that run over many lines
# (`- { width: .., pyramid_level: .., features: [ [x, y, l], ... ] }`).
# `parse_yaml` reads that subset: scalars are read by `_scalar`, and a flow
# scalar holds no `:` or `,`.

_FLOW_TOKEN = re.compile(r'\s*("[^"]*"|[\[\]{},:]|[^\[\]{},:\s][^\[\]{},:]*)')
_KEY = re.compile(r'^("[^"]*"|[^\s"\[\]{},:-][^:\[\]{}]*?):(?:\s+|$)(.*)$')


def _flow_depth(text: str) -> int:
    if '"' in text:
        text = re.sub(r'"[^"]*"', "", text)
    return text.count("[") + text.count("{") - text.count("]") - text.count("}")


def _block_lines(text: str) -> list:
    """(indent, content) per logical line. A flow collection's lines are
    joined into the line that opens it, and a `- key: value` item becomes a
    `-` line and a mapping line at the key's column."""
    out = []
    pending, depth = None, 0
    for line in text.splitlines():
        stripped = line.strip()
        if pending is not None:
            pending[1].append(stripped)
            depth += _flow_depth(stripped)
            if depth <= 0:
                out.append((pending[0], " ".join(pending[1])))
                pending = None
            continue
        if not stripped or stripped.startswith(("#", "%")) or stripped == "---":
            continue
        indent = len(line) - len(line.lstrip())
        while stripped.startswith("- ") and _KEY.match(stripped[2:].lstrip()):
            body = stripped[2:].lstrip()
            out.append((indent, "-"))
            indent += len(stripped) - len(body)
            stripped = body
        depth = _flow_depth(stripped)
        if depth > 0:
            pending = (indent, [stripped])
        else:
            out.append((indent, stripped))
    if pending is not None:
        raise ValueError("unterminated flow collection")
    return out


def _parse_flow(text: str):
    tokens = _FLOW_TOKEN.findall(text)
    pos = 0

    def value():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok == "[":
            items = []
            while tokens[pos] != "]":
                items.append(value())
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return items
        if tok == "{":
            items = {}
            while tokens[pos] != "}":
                key = _scalar(tokens[pos])
                if tokens[pos + 1] != ":":
                    raise ValueError(f"expected ':' after {key!r} in a flow mapping")
                pos += 2
                items[key] = value()
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return items
        return _scalar(tok)

    out = value()
    if pos != len(tokens):
        raise ValueError(f"trailing text after a flow collection: {text[:60]!r}")
    return out


def _value(text: str):
    if text.startswith(("[", "{")):
        return _parse_flow(text)
    return _scalar(text)


def _parse_block(lines: list, i: int, indent: int):
    """The node whose lines start at lines[i], at this indent -> (node, next i)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        items = []
        while i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
            if lines[i][1] == "-":
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    node, i = _parse_block(lines, i, lines[i][0])
                else:
                    node = None
            else:
                node = _value(lines[i][1][2:].strip())
                i += 1
            items.append(node)
        return items, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        m = _KEY.match(lines[i][1])
        if m is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = _scalar(m.group(1)), m.group(2).strip()
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (lines[i][0] == indent and lines[i][1][0] == "-")):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """Parse the block and flow YAML subset above into dicts, lists and
    scalars (`!!opencv-matrix` tags are dropped, so a matrix is a mapping)."""
    lines = _block_lines(text.replace("!!opencv-matrix", ""))
    if not lines:
        return {}
    node, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return node
