"""A reader of the OpenCV-YAML files ``cv2.FileStorage`` writes, for hosts
without ``yaml`` or ``cv2``.

It covers what the reference's settings files hold: the ``%YAML``
directive, comments, flat ``key: value`` lines, flow lists (``[a, b]``,
also over several lines), and one level of nested mapping, which is how an
``!!opencv-matrix`` node (``rows``, ``cols``, ``dt``, ``data``) is written.
Scalars resolve as pyyaml's ``safe_load`` resolves them (YAML 1.1): null,
booleans, ints, floats (with a dot, as YAML 1.1 asks), quoted and plain
strings; the JAX package reads these files through pyyaml after dropping
the directive and the matrix tag, and gets the same dict.
"""

from __future__ import annotations

import re
from typing import Dict

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON", "y",
         "Y"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF",
          "n", "N"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
# pyyaml's YAML 1.1 float: a dot is required
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$
    |\.[0-9_]+(?:[eE][-+][0-9]+)?$
    |[-+]?\.(?:inf|Inf|INF)$
    |\.(?:nan|NaN|NAN)$""", re.X)


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        inner = text[1:text.rindex("]")].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    return _scalar(text)


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one outside quotes, at the start
    or after a blank)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse(text: str) -> Dict:
    """The mapping of an OpenCV-YAML document."""
    out: Dict = {}
    lines = [_strip_comment(ln).rstrip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln.strip() and not ln.startswith("%")
             and ln.strip() != "---"]
    i = 0

    def item(i):
        """(key, value text, next line) of the ``key: value`` at line i,
        the value joined over lines while a flow list is open."""
        key, sep, rest = lines[i].strip().partition(":")
        if not sep:
            raise ValueError(f"not a 'key: value' line: {lines[i]!r}")
        rest = rest.replace("!!opencv-matrix", "").strip()
        i += 1
        while rest.count("[") > rest.count("]"):
            if i >= len(lines):
                raise ValueError(f"unclosed list under {key!r}")
            rest += " " + lines[i].strip()
            i += 1
        return _scalar(key), rest, i

    while i < len(lines):
        if lines[i][0] in " \t":
            raise ValueError(f"unexpected indentation: {lines[i]!r}")
        key, rest, i = item(i)
        if rest:
            out[key] = _value(rest)
            continue
        # a nested mapping (an opencv-matrix), or a null
        node = {}
        while i < len(lines) and lines[i][0] in " \t":
            k, v, i = item(i)
            node[k] = _value(v)
        out[key] = node or None
    return out


def load(path: str) -> Dict:
    """The mapping of the OpenCV-YAML file at ``path``."""
    with open(path) as f:
        return parse(f.read())
