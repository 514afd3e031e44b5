"""``${...}`` value interpolation (paper §5) — with compiled templates.

Supports intra-task references (``${keyword}``, ``${keyword:value}``) and
inter-task references (``${task:keyword}``, ``${task:keyword:value}``),
plus ``substitute`` partial-file-content rewriting where the keyword is a
Python regular expression and the value list provides replacements.

Two rendering paths produce byte-identical output:

* ``interpolate()`` — the reference implementation: regex substitution
  with a small fixpoint loop (one level of nested results).  O(len(text))
  regex work per instance.
* ``CompiledTemplate`` / ``compile_template()`` — the throughput path: a
  template is parsed **once** into alternating static segments and
  parameter slots, so rendering one instance is a list join over resolved
  slot values instead of a regex pass.  A 10^5-combination sweep pays the
  parse once per distinct template, not once per instance (parasweep's
  template pre-compilation, applied to the paper's §5 syntax).  The rare
  nested case — a resolved value that itself contains ``${...}`` — falls
  back to the reference fixpoint loop for the remaining passes, keeping
  the two paths byte-identical.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Any, Mapping

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class InterpolationError(KeyError):
    pass


def _fmt(v: Any) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def resolve(
    path: str,
    combo: Mapping[str, Any],
    task: str | None = None,
    studies: Mapping[str, Mapping[str, Any]] | None = None,
) -> Any:
    """Resolve one ``${path}`` reference.

    Lookup order (paper: both entry levels, intra- then inter-task):
      1. exact key in the current combination (``args:size``),
      2. bare user keyword (``size`` matching unique ``*:size``),
      3. task-qualified (``other_task:args:size``) against ``studies``.
    """
    if path in combo:
        return combo[path]
    tails = [k for k in combo if k.endswith(":" + path)]
    if len(tails) == 1:
        return combo[tails[0]]
    if studies:
        head, _, rest = path.partition(":")
        if head in studies and rest:
            other = studies[head]
            if rest in other:
                return other[rest]
            tails = [k for k in other if k.endswith(":" + rest)]
            if len(tails) == 1:
                return other[tails[0]]
    raise InterpolationError(f"cannot resolve ${{{path}}} (task={task!r})")


def classify_reference(
    path: str,
    scope: "set[str] | frozenset[str]",
    studies_scopes: Mapping[str, "set[str] | frozenset[str]"] | None = None,
) -> tuple[str, str]:
    """Statically classify one ``${path}`` reference against parameter
    *key sets* instead of a concrete combination.

    Mirrors :func:`resolve` exactly — same lookup order, same tie
    rules — so ``("ok", ...)`` here means ``resolve()`` succeeds for
    every instance, and anything else means it raises
    :class:`InterpolationError` for every instance.  This is what lets
    ``papas lint`` prove a 10^5-combination study renders without
    materializing a single combo.

    Returns ``(status, detail)`` with status ``"ok"``, ``"unbound"``,
    or ``"ambiguous"`` (both non-ok states raise at runtime; the split
    is diagnostic).
    """
    if path in scope:
        return "ok", ""
    tails = [k for k in scope if k.endswith(":" + path)]
    if len(tails) == 1:
        return "ok", ""
    head, _, rest = path.partition(":")
    if studies_scopes and head in studies_scopes and rest:
        other = studies_scopes[head]
        if rest in other:
            return "ok", ""
        otails = [k for k in other if k.endswith(":" + rest)]
        if len(otails) == 1:
            return "ok", ""
        if len(otails) > 1:
            return ("ambiguous",
                    f"{rest!r} matches {sorted(otails)} in task {head!r}")
        if len(tails) <= 1:
            return ("unbound",
                    f"task {head!r} declares no parameter {rest!r} "
                    f"(declared: {sorted(other) or 'none'})")
    if len(tails) > 1:
        return ("ambiguous",
                f"{path!r} matches multiple parameters {sorted(tails)}")
    detail = (f"no parameter of the task matches "
              f"(declared: {sorted(scope) or 'none'})")
    if rest and studies_scopes is not None and head not in studies_scopes:
        detail += f"; no task named {head!r} for an inter-task reference"
    return "unbound", detail


def interpolate(
    text: str,
    combo: Mapping[str, Any],
    task: str | None = None,
    studies: Mapping[str, Mapping[str, Any]] | None = None,
) -> str:
    """Expand every ``${...}`` in ``text`` against a parameter combination."""

    def _sub(m: re.Match[str]) -> str:
        return _fmt(resolve(m.group(1), combo, task, studies))

    prev, cur = None, text
    # allow one level of nested results (a value containing ${...})
    for _ in range(4):
        if prev == cur:
            break
        prev, cur = cur, _INTERP_RE.sub(_sub, cur)
    return cur


class CompiledTemplate:
    """A ``${...}`` template parsed once into static segments + slots.

    ``render`` resolves each slot against a combination and joins — no
    regex work on the hot path.  Output is byte-identical to
    ``interpolate(text, ...)``: the first substitution pass is performed
    by construction (the segment list mirrors ``_INTERP_RE`` matches
    exactly), and if resolved values re-introduce ``${...}`` the
    remaining fixpoint passes run through the same regex machinery the
    reference path uses.
    """

    __slots__ = ("text", "paths", "_parts")

    def __init__(self, text: str) -> None:
        self.text = text
        parts: list[tuple[bool, str]] = []   # (is_slot, literal-or-path)
        paths: list[str] = []
        pos = 0
        for m in _INTERP_RE.finditer(text):
            if m.start() > pos:
                parts.append((False, text[pos:m.start()]))
            parts.append((True, m.group(1)))
            paths.append(m.group(1))
            pos = m.end()
        if pos < len(text):
            parts.append((False, text[pos:]))
        self._parts = tuple(parts)
        #: every slot path, in order — lets callers reason about which
        #: parameters (and which inter-task references) a template needs
        self.paths = tuple(paths)

    @property
    def static(self) -> bool:
        """True when the template has no slots (render is free)."""
        return not self.paths

    def render(
        self,
        combo: Mapping[str, Any],
        task: str | None = None,
        studies: Mapping[str, Mapping[str, Any]] | None = None,
    ) -> str:
        if not self.paths:
            return self.text
        out: list[str] = []
        for is_slot, s in self._parts:
            out.append(_fmt(resolve(s, combo, task, studies))
                       if is_slot else s)
        cur = "".join(out)
        if "${" in cur:
            # a resolved value contained ${...}: finish with the same
            # fixpoint passes interpolate() applies after its first
            def _sub(m: re.Match[str]) -> str:
                return _fmt(resolve(m.group(1), combo, task, studies))

            prev = cur
            for _ in range(3):
                cur = _INTERP_RE.sub(_sub, cur)
                if cur == prev:
                    break
                prev = cur
        return cur


@lru_cache(maxsize=4096)
def compile_template(text: str) -> CompiledTemplate:
    """Parse-once cache: the same template text (a task's command, an
    environ value, a file template) compiles exactly once per process."""
    return CompiledTemplate(text)


class CompiledEnviron:
    """Pre-resolved ``environ`` key pairs for one task: per-instance
    rendering is a dict build over precomputed ``environ:VAR`` lookup
    keys — byte-identical to ``render_environ``."""

    __slots__ = ("_pairs",)

    def __init__(self, environ_keys: "tuple[str, ...] | Mapping[str, Any]"
                 ) -> None:
        self._pairs = tuple((var, f"environ:{var}") for var in environ_keys)

    def render(self, combo: Mapping[str, Any]) -> dict[str, str]:
        env: dict[str, str] = {}
        for var, key in self._pairs:
            if key in combo:
                env[var] = _fmt(combo[key])
        return env


@lru_cache(maxsize=1024)
def compile_environ(environ_keys: tuple[str, ...]) -> CompiledEnviron:
    """Parse-once cache for environ stamping, keyed by the variable
    name tuple."""
    return CompiledEnviron(environ_keys)


def substitute_content(
    content: str, rules: Mapping[str, Any]
) -> str:
    """Apply ``substitute`` rules to file content: each keyword is a
    Python regex, each value the chosen replacement for this instance."""
    out = content
    for pattern, replacement in rules.items():
        out = re.sub(pattern, _fmt(replacement), out)
    return out


def render_command(
    command: str,
    combo: Mapping[str, Any],
    task: str | None = None,
    studies: Mapping[str, Mapping[str, Any]] | None = None,
) -> str:
    """Render a task's command line for one workflow instance."""
    return interpolate(command, combo, task, studies)


def render_environ(
    environ_keys: Mapping[str, Any],
    combo: Mapping[str, Any],
) -> dict[str, str]:
    """Materialize the per-instance environment variable assignment."""
    env: dict[str, str] = {}
    for var in environ_keys:
        key = f"environ:{var}"
        if key in combo:
            env[var] = _fmt(combo[key])
    return env
