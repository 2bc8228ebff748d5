"""DET rules: results must not depend on when or where they were computed.

Scope: the determinism-critical modules — everything whose output feeds
measured values, seeds, caches, or serialized results.  For this repo that
is ``repro_torch/core/`` and ``repro_torch/cuda_bench/`` (searchers,
surrogates, the engine, work units, stores, the session driver, the CUDA
measurement pipeline) — the counterparts of the reference's ``repro/core/``
and ``repro/pallas_bench/``.  Files outside the ``repro_torch`` package
(fixtures, ad-hoc scripts passed explicitly) are always in scope.  The
analysis/telemetry/serving layers legitimately read wall clock (progress
logs, report walls) and are out of scope by construction, not by
suppression.

* **DET001** — non-injected wall clock.  ``time.time()`` and friends inside
  critical code make timing part of the result path; the one sanctioned
  seam is :mod:`repro_torch.core.clock` (which carries the allowlist
  entry).  CUDA-event timing (``torch.cuda.Event``) is a device timer, not
  a wall clock, and is no target.
* **DET002** — unseeded global randomness: ``np.random.<fn>()`` module-state
  draws and stdlib ``random.<fn>()``.  Constructing seeded generators
  (``default_rng``, ``Generator``, ``SeedSequence``...) is fine.
* **DET003** — iterating an unordered ``set`` where the order can feed
  downstream state, unless wrapped in ``sorted()``.  Order-insensitive
  reductions (``len``/``min``/``max``/``sum``/``any``/``all``) are exempt.
"""

from __future__ import annotations

import ast

from .catalog import RULES
from .findings import Finding

#: dotted names whose *call* is a DET001 violation
WALL_CLOCK_CALLS = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.process_time",
        "time.process_time_ns",
        "time.clock_gettime",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "datetime.datetime.today",
        "datetime.date.today",
    }
)

#: np.random attributes that construct *seeded* generators (allowed)
NP_RANDOM_OK = frozenset(
    {
        "default_rng",
        "Generator",
        "SeedSequence",
        "BitGenerator",
        "PCG64",
        "PCG64DXSM",
        "Philox",
        "MT19937",
        "SFC64",
    }
)

#: stdlib ``random`` module functions that draw from hidden global state
STDLIB_RANDOM_BANNED = frozenset(
    {
        "random",
        "randint",
        "randrange",
        "choice",
        "choices",
        "sample",
        "shuffle",
        "uniform",
        "gauss",
        "normalvariate",
        "betavariate",
        "expovariate",
        "seed",
        "getrandbits",
    }
)

#: calls whose result is order-insensitive — consuming a set through these
#: is deterministic
ORDER_INSENSITIVE = frozenset(
    {"len", "min", "max", "sum", "any", "all", "sorted", "frozenset", "set"}
)

#: consuming a set through these materializes its (arbitrary) order
ORDER_MATERIALIZING = frozenset({"list", "tuple", "iter", "enumerate", "zip"})

DET_CRITICAL_PARTS = ("repro_torch/core/", "repro_torch/cuda_bench/")


def is_det_critical(path: str) -> bool:
    p = path.replace("\\", "/")
    if "repro_torch/" not in p:
        return True  # fixtures / explicit files: always in scope
    return any(part in p for part in DET_CRITICAL_PARTS)


class _ImportMap:
    """Resolve ``name.attr.attr`` chains back to canonical module paths."""

    def __init__(self, tree: ast.AST):
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    self.alias[a.asname or a.name] = f"{node.module}.{a.name}"

    def dotted(self, node: ast.expr) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, or None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.alias.get(node.id, node.id)
        # normalize the one alias this codebase actually uses
        if head == "numpy":
            head = "np"
        parts.append(head)
        return ".".join(reversed(parts))


def walk_scope(scope: ast.AST):
    """Walk a scope's own statements without descending into nested
    function/class scopes (their names are their own)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(node))


def _scopes(tree: ast.AST):
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _ann_is_set(ann: ast.expr | None) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "frozenset")
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name):
        return ann.value.id in ("set", "frozenset")
    return False


def _set_typed_names(scope: ast.AST) -> set[str]:
    """Names assigned (or annotated as) an obvious set value in one scope."""
    names: set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
            if _ann_is_set(arg.annotation):
                names.add(arg.arg)
    for node in walk_scope(scope):
        value = None
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.target is not None:
            targets = [node.target]
            value = node.value
            ann = node.annotation
            ann_name = (
                ann.id
                if isinstance(ann, ast.Name)
                else ann.value.id
                if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name)
                else None
            )
            if ann_name in ("set", "frozenset"):
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        if value is not None and _is_set_expr(value, names):
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _is_set_expr(node: ast.expr, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    ):
        return True
    if isinstance(node, ast.Name) and node.id in set_names:
        return True
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitAnd, ast.BitOr, ast.BitXor, ast.Sub)
    ):
        # set algebra: a & b, keys_a - keys_b ... set-ness propagates
        return _is_set_expr(node.left, set_names) or _is_set_expr(
            node.right, set_names
        )
    return False


def check_file(path: str, tree: ast.AST) -> list[Finding]:
    findings: list[Finding] = []
    if not is_det_critical(path):
        return findings
    imap = _ImportMap(tree)

    def f(rule: str, node: ast.AST, msg: str) -> None:
        findings.append(
            Finding(
                path=path,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                rule=rule,
                message=msg,
                severity=RULES[rule].severity,
            )
        )

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = imap.dotted(node.func)
            if name is None:
                continue
            if name in WALL_CLOCK_CALLS:  # noqa: SIM114 — distinct messages
                f(
                    "DET001",
                    node,
                    f"non-injected wall clock {name}() in determinism-"
                    "critical code; use repro_torch.core.clock.monotonic()",
                )
            elif name.startswith("np.random."):
                attr = name.split(".", 2)[2]
                if "." not in attr and attr not in NP_RANDOM_OK:
                    f(
                        "DET002",
                        node,
                        f"np.random.{attr}() draws from unseeded global "
                        "state; use np.random.default_rng(seed)",
                    )
            elif name.startswith("random."):
                attr = name.split(".", 1)[1]
                if attr in STDLIB_RANDOM_BANNED:
                    f(
                        "DET002",
                        node,
                        f"stdlib random.{attr}() draws from unseeded global "
                        "state; use np.random.default_rng(seed)",
                    )
    # DET003 is scope-local: set-ness of a name is judged per function
    for scope in _scopes(tree):
        set_names = _set_typed_names(scope)
        for node in walk_scope(scope):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ORDER_MATERIALIZING
            ):
                for arg in node.args:
                    if _is_set_expr(arg, set_names):
                        f(
                            "DET003",
                            arg,
                            f"{node.func.id}() materializes unordered set "
                            "iteration order; wrap the set in sorted()",
                        )
            elif isinstance(node, ast.For):
                if _is_set_expr(node.iter, set_names):
                    f(
                        "DET003",
                        node.iter,
                        "for-loop over an unordered set; wrap in sorted() "
                        "if iteration order can feed results or serialized "
                        "output",
                    )
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
                for comp in node.generators:
                    if _is_set_expr(comp.iter, set_names):
                        f(
                            "DET003",
                            comp.iter,
                            "comprehension over an unordered set; wrap in "
                            "sorted() if order can feed results",
                        )
    return findings
