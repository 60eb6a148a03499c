"""Lossless TOML patching: programmatic writes that keep comments + order.

The port's copy of ``panoptikon_tpu/utils/toml_edit.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference carries a dedicated crate for this (panoptikon-config:
toml_edit-based before/after patching with atomic commits) because every
programmatic config write must leave the user's hand-written comments and
key order intact. Python has no baked-in equivalent here, so this is a
line-level editor for the subset config patching needs:

- set/get scalar values at ``section.key`` paths (top-level or one table
  deep — the shapes the server config uses);
- edits replace the value portion of the existing ``key = value`` line in
  place (comments on the line survive after the value);
- missing keys append at the end of their section; missing sections append
  at EOF;
- ``commit`` writes atomically (tempfile + rename).
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

_SECTION_RE = re.compile(r"^\s*\[\[?([^\]]+)\]\]?\s*(#.*)?$")
_KEY_RE = re.compile(r"^(\s*)([A-Za-z0-9_.\-\"']+)\s*=\s*(.*)$")


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(value, list):
        return "[" + ", ".join(_format_value(v) for v in value) + "]"
    raise TypeError(f"cannot format {type(value).__name__} as a TOML scalar")


def _split_value_comment(rest: str) -> tuple[str, str]:
    """Split 'value  # comment' respecting strings."""
    in_str: Optional[str] = None
    for i, ch in enumerate(rest):
        if in_str:
            if ch == in_str and rest[i - 1] != "\\":
                in_str = None
        elif ch in "\"'":
            in_str = ch
        elif ch == "#":
            return rest[:i].rstrip(), " " + rest[i:]
    return rest.rstrip(), ""


class TomlDocument:
    def __init__(self, text: str):
        self.lines = text.splitlines()
        self._trailing_newline = text.endswith("\n") or not text

    @classmethod
    def load(cls, path: str | Path) -> "TomlDocument":
        p = Path(path)
        return cls(p.read_text() if p.exists() else "")

    def text(self) -> str:
        out = "\n".join(self.lines)
        if self._trailing_newline and out:
            out += "\n"
        return out

    # -- internals ----------------------------------------------------------

    def _section_bounds(self, section: Optional[str]) -> tuple[int, int] | None:
        """(start, end) line range of a section body; section None = the
        top-level body before the first header."""
        current = None
        start = 0
        for i, line in enumerate(self.lines):
            m = _SECTION_RE.match(line)
            if m:
                if current == section or (section is None and current is None):
                    return (start, i)
                current = m.group(1).strip()
                start = i + 1
        if current == section or (section is None and current is None):
            return (start, len(self.lines))
        return None

    def set(self, path: str, value: Any) -> None:
        """Set ``key`` or ``section.key`` (first matching section wins)."""
        section, _, key = path.rpartition(".")
        section = section or None
        bounds = self._section_bounds(section)
        formatted = _format_value(value)
        if bounds is not None:
            start, end = bounds
            for i in range(start, end):
                m = _KEY_RE.match(self.lines[i])
                if m and m.group(2).strip("\"'") == key:
                    _, comment = _split_value_comment(m.group(3))
                    self.lines[i] = f"{m.group(1)}{m.group(2)} = {formatted}{comment}"
                    return
            # Append inside the section, before trailing blank lines.
            insert = end
            while insert > start and not self.lines[insert - 1].strip():
                insert -= 1
            self.lines.insert(insert, f"{key} = {formatted}")
            return
        # Section missing: append a new header + key at EOF.
        if self.lines and self.lines[-1].strip():
            self.lines.append("")
        self.lines.append(f"[{section}]")
        self.lines.append(f"{key} = {formatted}")

    def get_raw(self, path: str) -> Optional[str]:
        section, _, key = path.rpartition(".")
        bounds = self._section_bounds(section or None)
        if bounds is None:
            return None
        for i in range(*bounds):
            m = _KEY_RE.match(self.lines[i])
            if m and m.group(2).strip("\"'") == key:
                value, _ = _split_value_comment(m.group(3))
                return value
        return None

    def commit(self, path: str | Path) -> None:
        """Atomic write: tempfile in the same directory + rename."""
        path = Path(path)
        fd, tmp = tempfile.mkstemp(dir=path.parent or ".", prefix=".toml-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.text())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
