"""Reader for the OpenCV-FileStorage YAML subset the project's files use.

Counterpart of `linemod_tpu/utils/yamlcv.read_yamlcv`, without PyYAML. The
settings file, the per-model sidecars and the ground-truth pose files hold
only top-level `key: value` pairs, where a value is one of:

- a scalar: an integer, a float, a double-quoted string or a bare string;
- an inline list `[ a, b, ... ]`, which may run over several lines;
- an `!!opencv-matrix` block: indented `rows`, `cols`, `dt` and `data`
  entries, returned as a float64 numpy array of shape (rows, cols).

`%YAML` directives, `---` and `#` comment lines are skipped.

`parse_yaml` reads the deeper block-and-flow subset of the reference's
bank pair (`utils/refformat.py`), as PyYAML would after the JAX package's
sanitizing.
"""

from __future__ import annotations

import re

import numpy as np


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


def _inline_list(text: str) -> list:
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"malformed inline list: {text!r}")
    return [_scalar(v) for v in body[1:-1].split(",") if v.strip()]


def _logical_lines(text: str):
    """(indent, content) per entry, with multi-line inline lists joined."""
    pending = None
    for line in text.splitlines():
        stripped = line.strip()
        if pending is not None:
            pending = (pending[0], pending[1] + " " + stripped)
            if "]" in stripped:
                yield pending
                pending = None
            continue
        if not stripped or stripped.startswith(("#", "%")) or stripped == "---":
            continue
        entry = (len(line) - len(line.lstrip()), stripped)
        if "[" in stripped and "]" not in stripped:
            pending = entry
        else:
            yield entry
    if pending is not None:
        raise ValueError("unterminated inline list")


def parse_cvyaml(text: str) -> dict:
    """Parse FileStorage YAML text into a dict (matrices -> numpy arrays)."""
    out: dict = {}
    matrix_key = None
    matrix: dict = {}

    def close_matrix():
        if matrix_key is not None:
            data = np.asarray(matrix["data"], np.float64)
            out[matrix_key] = data.reshape(int(matrix["rows"]), int(matrix["cols"]))

    for indent, content in _logical_lines(text):
        key, sep, value = content.partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {content!r}")
        key = key.strip()
        value = value.strip()
        if matrix_key is not None and indent > 0:
            matrix[key] = _inline_list(value) if value.startswith("[") else _scalar(value)
            continue
        close_matrix()
        matrix_key = None
        if value == "!!opencv-matrix":
            matrix_key, matrix = key, {}
        elif value.startswith("["):
            out[key] = _inline_list(value)
        else:
            out[key] = _scalar(value)
    close_matrix()
    return out


def read_cvyaml(path: str) -> dict:
    """Read an OpenCV FileStorage YAML file into a dict."""
    with open(path) as f:
        return parse_cvyaml(f.read())


# -- the block and flow subset of the reference's bank pair ------------------
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
