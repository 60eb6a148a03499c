"""``${VAR}`` environment templating for config strings.

The port's copy of ``panoptikon_tpu/utils/env_template.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

Reference semantics (src/env_template.rs): ``${VAR}`` substitutes the
variable (error when unset), ``${VAR:-default}`` falls back when unset OR
empty, ``${VAR-default}`` only when unset, and ``$${`` escapes a literal
``${``. A ``.env`` file loads into the inherited environment without
overriding already-set variables.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Mapping, Optional


class TemplateError(ValueError):
    pass


_PATTERN = re.compile(
    r"""
    (?P<escape>\$\$\{) |
    \$\{(?P<name>[A-Za-z_][A-Za-z0-9_]*)
        (?:(?P<op>:-|-)(?P<default>[^}]*))?
    \}
    """,
    re.VERBOSE,
)


def resolve(template: str, env: Optional[Mapping[str, str]] = None) -> str:
    env = os.environ if env is None else env

    def sub(m: re.Match) -> str:
        if m.group("escape"):
            return "${"
        name = m.group("name")
        op = m.group("op")
        default = m.group("default")
        value = env.get(name)
        if op == ":-":
            return value if value else (default or "")
        if op == "-":
            return value if value is not None else (default or "")
        if value is None:
            raise TemplateError(f"environment variable {name!r} is not set")
        return value

    return _PATTERN.sub(sub, template)


def resolve_tree(value, env: Optional[Mapping[str, str]] = None):
    """Resolve every string in a nested config structure."""
    if isinstance(value, str):
        return resolve(value, env)
    if isinstance(value, dict):
        return {k: resolve_tree(v, env) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_tree(v, env) for v in value]
    return value


def load_dotenv(path: str | Path = ".env") -> dict[str, str]:
    """Parse a .env file into os.environ (never overriding existing vars).
    Returns the variables it actually set."""
    path = Path(path)
    loaded: dict[str, str] = {}
    if not path.is_file():
        return loaded
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip().strip('"').strip("'")
        if key and key not in os.environ:
            os.environ[key] = value
            loaded[key] = value
    return loaded
