"""AST-based linter of the port: the counterpart of the JAX package's
``repro.analysis.lint``, with the same machinery and the rules the port
needs.

The port's correctness claims (captured calls bit for bit the eager ones,
training reproducible from a seed, a CUDA tensor never running a plain
version) are properties of the source. A ``.item()`` inside a function a
CUDA graph captures, an unseeded ``torch.randn``, or a kernel entry point
that calls its plain version on every device each bring back a defect
that a test only catches after the fact, on the card. This module checks
them on the CPU, before any test runs.

Rules are registry entries: add one with :func:`register_rule` and
:func:`lint_source` / :func:`lint_paths` pick it up. The rules:

- ``wall-clock``: reads of the wall clock, as the reference has it;
- ``unseeded-random``: the reference's (the stdlib's and NumPy's global
  generators), plus torch's global generator: ``torch.manual_seed`` (and
  ``torch.seed`` and ``torch.cuda``'s seeding), and
  ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` and the in-place ``.uniform_()``,
  ``.normal_()`` (and the other in-place samplers) called without
  ``generator=``;
- ``bare-except``: as the reference has it;
- ``host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize`` and ``numpy.asarray``/``numpy.array`` of a
  value inside a function reachable from a capture site of the port: a
  function handed to ``CudaGraphCall(...)``, ``self._replay(...)`` or a
  ``StepGraphs()`` instance (``graphs = StepGraphs(); graphs(f, ...)``), the
  body of a ``with torch.cuda.graph(...)``, a ``jit_*`` or ``eval_step``
  method, or a kernel entry point (decorated with ``launch_site``). The
  reference roots it at ``jax.jit``/``vmap``/``pmap``/``make_jaxpr``,
  which the port never calls. Reachability is intra-module, by simple
  name, as in the reference: a call into another module is not followed;
- ``plain-pinned`` (the reference's ``interpret-pinned``): a kernel entry
  point that calls a plain version (a ``*_plain`` or ``ref_*`` function)
  other than under its ``_build.runs_plain(...)`` branch, so that the
  kernel would silently never run on the card;
- the reference's ``mutable-pytree`` has no counterpart: the port
  registers no pytrees, and a capture's operands (a ``DevicePlan``'s
  tensors among them) are copied into the graph's buffers at every call
  (``models/backend.py::_flatten``), so no object's later state can
  desynchronize a graph from it.

Per-site opt-out is an inline comment naming the rule, with its reason::

    t0 = time.perf_counter()  # lint: allow-wall-clock — the step's time

(a comment-only line directly above the site works too). There is no
baseline file: every exempt site says why, at the site.

>>> findings = lint_source("import torch\\n"
...                        "def f():\\n"
...                        "    return torch.randn(3)\\n")
>>> [(f.rule, f.line) for f in findings]
[('unseeded-random', 3)]
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Callable, Iterable, Iterator

__all__ = [
    "Finding",
    "LintRule",
    "Module",
    "RULES",
    "lint_paths",
    "lint_source",
    "register_rule",
]


# ---------------------------------------------------------------------------
# findings + rule registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit. ``key`` identifies the finding WITHOUT its line
    number (path, rule and the site's source line), so it survives edits
    that move the site around the file."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.snippet}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


@dataclasses.dataclass(frozen=True)
class LintRule:
    """A registered rule: ``fn(module) -> iterable[Finding]`` plus the
    defect it guards against."""

    name: str
    history: str
    fn: Callable[["Module"], Iterable[Finding]]


#: rule name -> :class:`LintRule`; the latest registration wins.
RULES: dict[str, LintRule] = {}


def register_rule(name: str, *, history: str = "") -> Callable:
    """Decorator: register ``fn(module) -> iterable[Finding]`` under
    ``name``. Sites opt out with ``# lint: allow-<name>``."""
    def deco(fn: Callable) -> Callable:
        RULES[name] = LintRule(name, history, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# the parsed module
# ---------------------------------------------------------------------------

_ALLOW_RE = re.compile(r"#\s*lint:\s*((?:allow-[\w-]+[,\s]*)+)")
_ALLOW_TOKEN = re.compile(r"allow-([\w-]+)")
_COMMENT_ONLY = re.compile(r"^\s*#")


class Module:
    """One source file, parsed once and shared by every rule: the AST, an
    import alias table (local name -> dotted module path, so ``np.asarray``
    and ``numpy.asarray`` resolve alike), and the pragmas' line map."""

    def __init__(self, source: str, path: str = "<string>"):
        self.source = source
        self.path = path
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.aliases = self._alias_table(self.tree)
        self._allows = self._allow_map(self.lines)

    # -- imports ------------------------------------------------------------

    @staticmethod
    def _alias_table(tree: ast.AST) -> dict[str, str]:
        table: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    table[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                for a in node.names:
                    table[a.asname or a.name] = f"{node.module}.{a.name}"
        return table

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted path of a Name/Attribute chain through the alias table
        (``np.random.uniform`` -> ``numpy.random.uniform``), or None when
        the base name was never imported (locals never match module
        rules)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    # -- pragmas ------------------------------------------------------------

    @staticmethod
    def _allow_map(lines: list[str]) -> dict[int, set[str]]:
        allows: dict[int, set[str]] = {}
        for i, text in enumerate(lines, start=1):
            m = _ALLOW_RE.search(text)
            if not m:
                continue
            rules = set(_ALLOW_TOKEN.findall(m.group(1)))
            allows.setdefault(i, set()).update(rules)
            if _COMMENT_ONLY.match(text):     # standalone comment: next line
                allows.setdefault(i + 1, set()).update(rules)
        return allows

    def allowed(self, line: int, rule: str) -> bool:
        return rule in self._allows.get(line, ())

    # -- finding constructor ------------------------------------------------

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule, path=self.path, line=line,
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message, snippet=snippet)

    def calls(self) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node


# ---------------------------------------------------------------------------
# rule: wall-clock reads
# ---------------------------------------------------------------------------

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}


@register_rule(
    "wall-clock",
    history="A bug the reference once had: serve_stream measured "
            "service time on the wall clock, so p50/p99 were "
            "nondeterministic; the fix "
            "was an injectable clock (VirtualClock, which the port's "
            "serving tier keeps). Wall-clock reads belong behind a clock= "
            "seam, or behind a '# lint: allow-wall-clock' saying why not.")
def rule_wall_clock(mod: Module) -> Iterator[Finding]:
    for call in mod.calls():
        dotted = mod.resolve(call.func)
        if dotted in _WALL_CLOCK and not mod.allowed(call.lineno,
                                                     "wall-clock"):
            yield mod.finding(
                "wall-clock", call,
                f"{dotted}() is a wall-clock read; take an injectable "
                f"clock (see launch.serve.VirtualClock) or annotate the "
                f"site with '# lint: allow-wall-clock'")


# ---------------------------------------------------------------------------
# rule: unseeded / module-global randomness
# ---------------------------------------------------------------------------

#: numpy.random names that ARE the seeded API
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64"}
#: stdlib random names that construct a seedable instance
_PY_RANDOM_OK = {"Random", "SystemRandom", "getstate", "setstate"}
#: torch functions that draw from the global generator unless handed one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial"}
#: in-place samplers of a tensor, the global generator unless handed one
_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                     "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register_rule(
    "unseeded-random",
    history="The reference's launch/fault.py once drew retry's jitter "
            "from the module-global random.uniform, so any "
            "path through retry was nondeterministic. The port adds "
            "torch's global generator: torch.manual_seed reseeds every "
            "caller in the process, and a sampler without generator= "
            "draws from that shared state. Inject a seeded "
            "np.random.default_rng(seed) or a torch.Generator.")
def rule_unseeded_random(mod: Module) -> Iterator[Finding]:
    for call in mod.calls():
        if mod.allowed(call.lineno, "unseeded-random"):
            continue
        dotted = mod.resolve(call.func)
        parts = dotted.split(".") if dotted else []
        if parts[:1] == ["random"] and len(parts) == 2 \
                and parts[1] not in _PY_RANDOM_OK:
            yield mod.finding(
                "unseeded-random", call,
                f"{dotted}() uses the module-global stdlib RNG; inject a "
                f"seeded generator (np.random.default_rng(seed) / "
                f"random.Random(seed)) instead")
        elif parts[:2] == ["numpy", "random"] and len(parts) == 3 \
                and parts[2] not in _NP_RANDOM_OK:
            yield mod.finding(
                "unseeded-random", call,
                f"{dotted}() is the legacy global-state numpy RNG; use "
                f"np.random.default_rng(seed) or an injected Generator")
        elif dotted in ("torch.manual_seed", "torch.cuda.manual_seed",
                        "torch.cuda.manual_seed_all", "torch.seed"):
            yield mod.finding(
                "unseeded-random", call,
                f"{dotted}() reseeds torch's global generator for every "
                f"caller in the process; hand a seeded torch.Generator to "
                f"the sampler instead")
        elif len(parts) == 2 and parts[0] == "torch" \
                and parts[1] in _TORCH_SAMPLERS and not _has_generator(call):
            yield mod.finding(
                "unseeded-random", call,
                f"{dotted}() without generator= draws from torch's global "
                f"generator; pass a seeded torch.Generator")
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INPLACE_SAMPLERS \
                and not _has_generator(call):
            yield mod.finding(
                "unseeded-random", call,
                f".{call.func.attr}() without generator= draws from "
                f"torch's global generator; pass a seeded torch.Generator")


# ---------------------------------------------------------------------------
# rule: host sync inside functions reachable from a capture site
# ---------------------------------------------------------------------------

_HOST_SYNC_FNS = {"numpy.asarray", "numpy.array", "numpy.asanyarray",
                  "numpy.ascontiguousarray"}
#: tensor methods that copy to the host (``item``/``tolist`` only without
#: arguments, as the reference matches them)
_HOST_SYNC_METHODS = {"item", "tolist"}
_HOST_COPY_METHODS = {"cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}


def _defs_by_name(tree: ast.AST) -> dict[str, list[ast.AST]]:
    defs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _simple_name(node: ast.AST) -> str | None:
    """``f`` for ``f`` / ``self.f`` / ``obj.f``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _callable_name(node: ast.AST, mod: Module) -> str | None:
    """The simple name a callable expression refers to, unwrapping
    ``functools.partial``."""
    if isinstance(node, ast.Call):                 # partial(f, ...)
        dotted = mod.resolve(node.func)
        if dotted in ("functools.partial", "partial") and node.args:
            return _callable_name(node.args[0], mod)
        return None
    return _simple_name(node)


def _decorated_launch_site(node: ast.AST) -> bool:
    for deco in node.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if _simple_name(target) == "launch_site":
            return True
    return False


def _is_graph_block(item: ast.withitem, mod: Module) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and (
        mod.resolve(expr.func) == "torch.cuda.graph")


def _graph_blocks(mod: Module) -> list[tuple[str, list[ast.stmt]]]:
    """The bodies of ``with torch.cuda.graph(...)`` blocks, each with the
    name of the function that holds it (``<module>`` at top level)."""
    out = []

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            name = owner
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_block(i, mod) for i in child.items):
                out.append((name, child.body))
            visit(child, name)
    visit(mod.tree, "<module>")
    return out


def _capture_roots(mod: Module, defs: dict[str, list[ast.AST]],
                   blocks) -> set[str]:
    """The functions a CUDA graph captures or a kernel launch runs: handed
    to ``CudaGraphCall(...)``, ``self._replay(...)`` or a name bound to a
    ``StepGraphs()`` instance, called in a ``with torch.cuda.graph(...)``
    body, named ``jit_*`` or ``eval_step``, or decorated with
    ``launch_site``."""
    roots: set[str] = set()
    steppers = {t.id for node in ast.walk(mod.tree)
                if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _simple_name(node.value.func) == "StepGraphs"
                for t in node.targets if isinstance(t, ast.Name)}
    for call in mod.calls():
        func = call.func
        handed = (_simple_name(func) == "CudaGraphCall"
                  or (isinstance(func, ast.Attribute)
                      and func.attr == "_replay")
                  or (isinstance(func, ast.Name) and func.id in steppers))
        if handed and call.args:
            name = _callable_name(call.args[0], mod)
            if name is not None:
                roots.add(name)
    for _, body in blocks:
        for stmt in body:
            for c in ast.walk(stmt):
                if isinstance(c, ast.Call):
                    name = _callable_name(c.func, mod)
                    if name is not None:
                        roots.add(name)
    for name, nodes in defs.items():
        if name.startswith("jit_") or name == "eval_step" or any(
                _decorated_launch_site(n) for n in nodes):
            roots.add(name)
    return roots & set(defs)


def _reachable(defs: dict[str, list[ast.AST]], roots: set[str]) -> set[str]:
    """Name-level BFS over the intra-module call graph: ``f()`` and
    ``self.f()`` / ``cls.f()`` edges (methods resolved by simple name:
    over-reaches, never under-reaches within the module)."""
    seen = set()
    frontier = list(roots)
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in defs.get(name, ()):
            for c in ast.walk(node):
                if not isinstance(c, ast.Call):
                    continue
                callee = None
                if isinstance(c.func, ast.Name):
                    callee = c.func.id
                elif isinstance(c.func, ast.Attribute) and \
                        isinstance(c.func.value, ast.Name) and \
                        c.func.value.id in ("self", "cls"):
                    callee = c.func.attr
                if callee in defs and callee not in seen:
                    frontier.append(callee)
    return seen


def _literal(node: ast.AST) -> bool:
    """A constant, or a list/tuple of them: no tensor to copy back."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_literal(e) for e in node.elts)
    return False


def _host_sync(mod: Module, c: ast.Call) -> str | None:
    """What of ``c`` syncs with the host, or None."""
    dotted = mod.resolve(c.func)
    if dotted in _SYNC_CALLS:
        return f"{dotted}()"
    if dotted in _HOST_SYNC_FNS and c.args and not _literal(c.args[0]):
        return f"{dotted}()"
    if isinstance(c.func, ast.Attribute):
        attr = c.func.attr
        if attr in _HOST_SYNC_METHODS and not c.args and not c.keywords:
            return f".{attr}()"
        if attr in _HOST_COPY_METHODS and dotted is None:
            return f".{attr}()"
    return None


@register_rule(
    "host-sync",
    history="The reference's host-sync bug class, on the card: a value read "
            "back to the host inside a captured call either breaks the "
            "capture or, in an eager call, stalls the card. The port's "
            "capture sites (CudaGraphCall, _replay, torch.cuda.graph, "
            "jit_*/eval_step) and its kernel entry points (launch_site) "
            "must not sync; a host-side site reachable from them (host "
            "planning, a plain version on the CPU) annotates itself with "
            "'# lint: allow-host-sync' and its reason.")
def rule_host_sync(mod: Module) -> Iterator[Finding]:
    defs = _defs_by_name(mod.tree)
    blocks = _graph_blocks(mod)
    roots = _capture_roots(mod, defs, blocks)
    scopes = [(name, fn) for name in sorted(_reachable(defs, roots))
              for fn in defs[name]]
    scopes += [(owner, stmt) for owner, body in blocks for stmt in body]
    seen_nodes: set[int] = set()
    for name, scope in scopes:
        for c in ast.walk(scope):
            if not isinstance(c, ast.Call) or id(c) in seen_nodes:
                continue
            seen_nodes.add(id(c))
            what = _host_sync(mod, c)
            if what is None or mod.allowed(c.lineno, "host-sync"):
                continue
            yield mod.finding(
                "host-sync", c,
                f"{what} in '{name}' (reachable from a capture site or a "
                f"kernel entry point) syncs the card with the host")


# ---------------------------------------------------------------------------
# rule: a kernel entry point that runs its plain version unconditionally
# ---------------------------------------------------------------------------

def _is_plain_twin(name: str | None) -> bool:
    return name is not None and name != "runs_plain" and (
        name.endswith("_plain") or name.startswith("ref_"))


def _tests_runs_plain(test: ast.AST) -> bool:
    """True when ``test`` is a ``runs_plain(...)`` call (a bare or
    ``_build.`` one), not negated."""
    return isinstance(test, ast.Call) and \
        _simple_name(test.func) == "runs_plain"


def _unguarded_plain_calls(node: ast.AST, guarded: bool = False):
    """The plain-version calls under ``node`` that no ``runs_plain``
    branch guards."""
    if isinstance(node, (ast.If, ast.IfExp)) and _tests_runs_plain(
            node.test):
        body = node.body if isinstance(node, ast.If) else [node.body]
        orelse = node.orelse if isinstance(node, ast.If) else [node.orelse]
        yield from _unguarded_plain_calls(node.test, guarded)
        for child in body:
            yield from _unguarded_plain_calls(child, True)
        for child in orelse:
            yield from _unguarded_plain_calls(child, guarded)
        return
    if isinstance(node, ast.Call) and not guarded \
            and _is_plain_twin(_simple_name(node.func)):
        yield node
    for child in ast.iter_child_nodes(node):
        yield from _unguarded_plain_calls(child, guarded)


@register_rule(
    "plain-pinned",
    history="The reference's interpret-pinned: a pallas_call that "
            "hardcodes interpret=True silently never runs compiled. The "
            "port's form: a kernel entry point (launch_site) that calls "
            "its plain version outside its _build.runs_plain(...) branch "
            "runs the twin on CUDA tensors too, and the kernel never "
            "launches; the launch counters stay at zero, and only a run "
            "on the card would show it.")
def rule_plain_pinned(mod: Module) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or not _decorated_launch_site(node):
            continue
        for stmt in node.body:
            for call in _unguarded_plain_calls(stmt):
                if mod.allowed(call.lineno, "plain-pinned"):
                    continue
                yield mod.finding(
                    "plain-pinned", call,
                    f"kernel entry point '{node.name}' calls the plain "
                    f"version {_simple_name(call.func)}() outside its "
                    f"_build.runs_plain(...) branch: on the card the "
                    f"kernel would never launch")


# ---------------------------------------------------------------------------
# rule: bare except
# ---------------------------------------------------------------------------

@register_rule(
    "bare-except",
    history="A bare 'except:' swallows KeyboardInterrupt/SystemExit: in "
            "the serving loop that turns a Ctrl-C into a hung engine, and "
            "in retry wrappers it hides the very fault being retried. "
            "Catch the narrowest exception that is expected.")
def rule_bare_except(mod: Module) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and not mod.allowed(node.lineno, "bare-except"):
            yield mod.finding(
                "bare-except", node,
                "bare 'except:' catches KeyboardInterrupt/SystemExit; "
                "name the exception classes this site expects")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>",
                rules: Iterable[str] | None = None) -> list[Finding]:
    """Run the selected ``rules`` (default: all registered) over one
    source string. Returns findings sorted by (line, col, rule)."""
    mod = Module(source, path)
    selected = list(RULES) if rules is None else list(rules)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown lint rule(s) {unknown}; registered: "
                         f"{sorted(RULES)}")
    out: list[Finding] = []
    for name in selected:
        out.extend(RULES[name].fn(mod))
    return sorted(out, key=lambda f: (f.line, f.col, f.rule))


def lint_paths(paths: Iterable[str | pathlib.Path],
               rules: Iterable[str] | None = None,
               root: str | pathlib.Path | None = None) -> list[Finding]:
    """Lint ``.py`` files (directories recurse). Finding paths are
    reported relative to ``root`` (default: cwd), so keys do not depend on
    the checkout's place. A syntax error is a finding of the pseudo-rule
    ``parse-error``, not an abort."""
    root = pathlib.Path(root) if root is not None else pathlib.Path.cwd()
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: list[Finding] = []
    for f in files:
        try:
            rel = str(f.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(f)
        try:
            out.extend(dataclasses.replace(x, path=rel)
                       for x in lint_source(f.read_text(), rel, rules))
        except SyntaxError as e:
            out.append(Finding(rule="parse-error", path=rel,
                               line=e.lineno or 0, col=e.offset or 0,
                               message=f"could not parse: {e.msg}"))
    return out


def main(argv=None) -> int:
    """``python -m repro_torch.analysis [paths...]``: print every finding
    over ``paths`` (default: ``src/repro_torch`` and
    ``examples/*_torch.py`` under the current directory); exit 1 if there
    is any."""
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    cwd = pathlib.Path.cwd()
    paths = args or [cwd / "src" / "repro_torch",
                     *sorted((cwd / "examples").glob("*_torch.py"))]
    findings = lint_paths(paths, root=cwd)
    for f in findings:
        print(f)
    return 1 if findings else 0
