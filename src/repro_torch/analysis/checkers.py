"""The port's AST checkers: the counterparts of `repro.analysis.checkers`
for PyTorch programs captured as CUDA graphs.

Each checker encodes a hazard the port has met:

    host-sync             `.item()/.tolist()/.cpu()/.numpy()`, and
                          `float()/int()/bool()` of an indexed or computed
                          value: anywhere inside a captured body, and in
                          the hot packages (core/ kernels/ sim/ serve/
                          obs/ fleet/ scenarios/) even outside one
    capture-safety        inside a captured body, a tensor made from host
                          values (`torch.tensor`, `torch.as_tensor`,
                          `torch.from_numpy`) or a host scalar written
                          into an indexed slot (`t[idx] = 0.5`): a
                          host-to-device copy, which a capture refuses
                          (the capture rule)
    dtype-drift           np/torch zeros/ones/full/empty/arange without
                          an explicit dtype in arena and training code
                          (core/ train/ kernels/)
    fingerprint-coverage  fields of M4Config, SimRequest and NetConfig
                          that no fingerprint/content_hash/shard_key
                          reflects (a stale-cache hazard)
    retrace-hazard        a `compiled.run`, `StepCache` or CUDA graph
                          made inside a loop body, and a `compiled.run`
                          whose key leaves out a non-tensor input that
                          shapes the program its `build` makes (a second
                          call with another value would replay the
                          first's program)

A *captured body* is code that runs while a CUDA graph is captured: the
`event` and `sample` functions of a `core.compiled.Program`, the `body`
of a `StepProgram`, and the steps a program stores in its `steps`; and,
followed across the scanned modules, every function they call by name or
through a module (`dispatch.waterfill_event`), the functions a factory
they call returns (`step = make_event_step(...)`), the functions passed
to a captured function's parameters, and those closed over from the
parameters of its enclosing functions (a training step's `schedule`).
Method calls on objects are not followed.

`tracer-leak` and `donation-misuse` have no counterpart. A tensor made
at import time is a plain tensor, not a tracer that can leak out of a
trace; and PyTorch has no buffer donation: a compiled program owns its
buffers, and a call copies its inputs into them.

The checkers are syntactic: no import of the scanned code, no torch at
analysis time. A false positive goes into the baseline with a one-line
justification, or behind an inline `# lint-torch: disable=<checker>`.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .findings import Finding

PRAGMA_RE = re.compile(r"lint-torch:\s*disable=([\w,\-]+)")

HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods whose result is host data already: sizes, and str/dict methods
HOST_METHODS = {
    "size", "dim", "numel", "nelement", "stride", "element_size", "get",
    "pop", "count", "index", "split", "strip", "rstrip", "lstrip",
    "startswith", "endswith", "format", "join", "replace", "read",
    "group", "keys", "values", "items", "setdefault", "hexdigest",
    "decode", "encode", "bit_length", "lower", "upper", "total_seconds"}
# constructors whose default dtype is a policy choice (numpy's float64,
# torch's `set_default_dtype`, or the fill value's Python type)
DTYPE_REQUIRED = {"zeros", "ones", "full", "empty", "arange"}
# index of the positional argument that may carry a numpy dtype
NP_DTYPE_POSITION = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
                     "arange": 3}
HOST_TENSOR_CTORS = {"tensor", "as_tensor", "from_numpy"}
SCALAR_TYPES = {"float", "int", "bool"}
FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
SCOPES = FUNCS + (ast.ClassDef,)
MAX_DEPTH = 16


@dataclass(eq=False)
class ModuleSource:
    """One parsed file plus the maps the checkers query."""
    path: str                      # repo-relative, forward slashes
    text: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    np_aliases: Set[str] = field(default_factory=set)     # -> numpy
    torch_aliases: Set[str] = field(default_factory=set)  # -> torch
    parents: Dict[int, ast.AST] = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str, path: str) -> "ModuleSource":
        mod = cls(path=path.replace("\\", "/"), text=text,
                  tree=ast.parse(text), lines=text.splitlines())
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                mod.parents[id(child)] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        mod.np_aliases.add(a.asname or "numpy")
                    elif a.name == "torch":
                        mod.torch_aliases.add(a.asname or "torch")
        return mod

    def src(self, node: ast.AST) -> str:
        line = getattr(node, "lineno", 0)
        return self.lines[line - 1].strip() if 0 < line <= len(self.lines) \
            else ""

    def suppressed(self, node: ast.AST, checker: str) -> bool:
        """`# lint-torch: disable=<checker>[,<checker>]` on the offending
        line or the line directly above silences that line."""
        line = getattr(node, "lineno", 0)
        for ln in (line, line - 1):
            if 0 < ln <= len(self.lines):
                m = PRAGMA_RE.search(self.lines[ln - 1])
                if m and (checker in m.group(1).split(",")
                          or m.group(1) == "all"):
                    return True
        return False

    def attr_chain(self, node: ast.AST) -> List[str]:
        """`torch.cuda.CUDAGraph` -> ["torch", "cuda", "CUDAGraph"]; [] if
        not a plain name/attribute chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return parts[::-1]
        return []

    def scope_of(self, node: ast.AST) -> Optional[ast.AST]:
        """The function (def or lambda) whose scope holds `node`, or None
        for the module; class bodies are skipped, as Python's name
        resolution skips them."""
        p = self.parents.get(id(node))
        while p is not None and not isinstance(p, FUNCS):
            p = self.parents.get(id(p))
        return p


# ---------------------------------------------------------------- project
def _own_nodes(scope) -> Iterator[ast.AST]:
    """The nodes of a function's (or module's) body that belong to its own
    scope: nested defs, lambdas and classes are yielded, not entered."""
    if isinstance(scope, ast.Lambda):
        stack = [scope.body]
    else:
        stack = list(reversed(scope.body))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, SCOPES):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _params(fn) -> List[ast.arg]:
    a = fn.args
    return (a.posonlyargs + a.args + a.kwonlyargs
            + ([a.vararg] if a.vararg else [])
            + ([a.kwarg] if a.kwarg else []))


def _default_of(fn, name: str) -> Optional[ast.AST]:
    a = fn.args
    pos = a.posonlyargs + a.args
    for arg, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if arg.arg == name:
            return d
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        if arg.arg == name:
            return d
    return None


def _binds(node: ast.AST, name: str) -> bool:
    """Whether a statement node binds `name` in its scope."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node.name == name
    if isinstance(node, ast.Name):
        return node.id == name and isinstance(node.ctx, ast.Store)
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return any((a.asname or a.name.split(".")[0]) == name
                   for a in node.names)
    return False


class Project:
    """The scanned modules as one program: name resolution across them,
    and the set of captured bodies."""

    def __init__(self, mods: Sequence[ModuleSource]):
        self.mods = list(mods)
        self.by_path = {m.path: m for m in self.mods}
        self.calls: Dict[str, List[Tuple[ModuleSource, ast.Call]]] = {}
        for m in self.mods:
            for node in ast.walk(m.tree):
                if isinstance(node, ast.Call):
                    f = node.func
                    name = f.id if isinstance(f, ast.Name) else \
                        f.attr if isinstance(f, ast.Attribute) else None
                    if name:
                        self.calls.setdefault(name, []).append((m, node))
        self.captured: Dict[int, Tuple[ModuleSource, ast.AST]] = {}
        self._tables: Dict[int, Dict[str, list]] = {}
        self._memo: Dict[Tuple[int, int], list] = {}
        self._find_captured()

    # ---------------------------------------------------------- modules
    def _module(self, dotted_dir: str) -> Optional[ModuleSource]:
        for cand in (dotted_dir + ".py", dotted_dir + "/__init__.py"):
            if cand in self.by_path:
                return self.by_path[cand]
        return None

    def _import_base(self, mod: ModuleSource, node: ast.ImportFrom
                     ) -> Optional[str]:
        """The directory path of an ImportFrom's module, relative to the
        scan root, or None outside the scanned package."""
        parts = mod.path.split("/")[:-1]
        if node.level:
            if node.level - 1 > len(parts):
                return None
            base = parts[:len(parts) - (node.level - 1)]
        else:
            top = (node.module or "").split(".")[0]
            if top not in parts:
                return None
            base = parts[:parts.index(top)]
            return "/".join(base + (node.module or "").split("."))
        return "/".join(base + ([*(node.module or "").split(".")]
                                if node.module else []))

    def _import_targets(self, mod, node, name, depth) -> list:
        if isinstance(node, ast.Import):
            return []
        base = self._import_base(mod, node)
        if base is None:
            return []
        for a in node.names:
            if (a.asname or a.name) != name:
                continue
            sub = self._module(f"{base}/{a.name}")
            if sub is not None:
                return [("module", sub, None)]
            owner = self._module(base)
            if owner is not None and owner is not mod:
                return self._lookup(owner, a.name, None, depth + 1)[1]
        return []

    # ------------------------------------------------------- resolution
    def resolve_name(self, mod, name: str, scope, depth=0) -> list:
        """What `name` read in `scope` (a function node or None) names:
        a list of ("func", mod, node) and ("module", mod, None)."""
        if depth > MAX_DEPTH:
            return []
        s = scope
        while True:
            found, out = self._lookup(mod, name, s, depth)
            if found or s is None:
                return out
            s = mod.scope_of(s)

    def _bindings(self, mod, scope) -> Dict[str, list]:
        """name -> what binds it in one scope: ("def", node), ("value",
        expression), ("import", node) or ("other", None)."""
        key = id(scope) if scope is not None else id(mod.tree)
        table = self._tables.get(key)
        if table is not None:
            return table
        table = {}
        for p in (_params(scope) if scope is not None else ()):
            table.setdefault(p.arg, []).append(("param", None))
        for node in _own_nodes(scope if scope is not None else mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table.setdefault(node.name, []).append(("def", node))
            elif isinstance(node, ast.ClassDef):
                table.setdefault(node.name, []).append(("other", None))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    table.setdefault(a.asname or a.name.split(".")[0],
                                     []).append(("import", node))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        table.setdefault(t.id, []).append(
                            ("value", node.value))
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                            ast.Store):
                table.setdefault(node.id, []).append(("other", None))
        self._tables[key] = table
        return table

    def _lookup(self, mod, name, scope, depth) -> Tuple[bool, list]:
        """(bound here, targets) for `name` in one scope."""
        binds = self._bindings(mod, scope).get(name)
        if not binds:
            return False, []
        out = []
        for kind, what in binds:
            if kind == "param":
                return True, self._param_values(mod, scope, name, depth)
            if kind == "def":
                out.append(("func", mod, what))
            elif kind == "import":
                out += self._import_targets(mod, what, name, depth)
            elif kind == "value" and what is not None:
                out += self.resolve_expr(mod, what, scope, depth + 1)
        return True, out

    def resolve_expr(self, mod, expr, scope, depth=0) -> list:
        """The functions (or modules) an expression evaluates to
        (memoized within one pass of `_find_captured`)."""
        if depth > MAX_DEPTH:
            return []
        key = (id(expr), id(scope))
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = []            # a cycle resolves to nothing
        out = self._resolve_expr(mod, expr, scope, depth)
        self._memo[key] = out
        return out

    def _resolve_expr(self, mod, expr, scope, depth) -> list:
        if isinstance(expr, ast.Lambda):
            return [("func", mod, expr)]
        if isinstance(expr, ast.Name):
            return self.resolve_name(mod, expr.id, scope, depth + 1)
        if isinstance(expr, ast.Attribute):
            method = self._method(mod, expr, scope)
            if method is not None:
                return [("func", mod, method)]
            out = []
            for kind, m, _ in self.resolve_expr(mod, expr.value, scope,
                                                depth + 1):
                if kind == "module":
                    out += self._lookup(m, expr.attr, None, depth + 1)[1]
            return out
        if isinstance(expr, ast.IfExp):
            return self.resolve_expr(mod, expr.body, scope, depth + 1) \
                + self.resolve_expr(mod, expr.orelse, scope, depth + 1)
        if isinstance(expr, ast.Call):          # a factory's result
            out = []
            for kind, m, fn in self.resolve_expr(mod, expr.func, scope,
                                                 depth + 1):
                if kind == "func" and not isinstance(fn, ast.Lambda):
                    out += self._returned(m, fn, depth + 1)
            return out
        return []

    @staticmethod
    def _method(mod, expr, scope):
        """`self.name` inside a method: the class's own method `name`."""
        if not (isinstance(expr.value, ast.Name) and expr.value.id == "self"
                and isinstance(scope, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))):
            return None
        cls = mod.parents.get(id(scope))
        if not isinstance(cls, ast.ClassDef):
            return None
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == expr.attr:
                return node
        return None

    def _returned(self, mod, fn, depth) -> list:
        out = []
        for node in _own_nodes(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                out += self.resolve_expr(mod, node.value, fn, depth + 1)
        return out

    def _param_values(self, mod, fn, name, depth) -> list:
        """The functions passed to parameter `name` of `fn`, from its call
        sites: those inside captured bodies if `fn` is itself captured
        (its calls there are the ones the capture runs), else all."""
        if isinstance(fn, ast.Lambda) or isinstance(
                mod.parents.get(id(fn)), ast.ClassDef):
            return []
        captured_only = id(fn) in self.captured
        pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        out = []
        for cmod, call in self.calls.get(fn.name, ()):
            if captured_only and not self._in_captured(cmod, call):
                continue
            cscope = cmod.scope_of(call)
            if not any(t[2] is fn for t in self.resolve_expr(
                    cmod, call.func, cscope, depth + 1)):
                continue
            arg = None
            if name in pos:
                i = pos.index(name)
                if i < len(call.args) and not any(
                        isinstance(a, ast.Starred) for a in call.args[:i + 1]):
                    arg = call.args[i]
            for kw in call.keywords:
                if kw.arg == name:
                    arg = kw.value
            if arg is not None:
                out += self.resolve_expr(cmod, arg, cscope, depth + 1)
        default = _default_of(fn, name)
        if default is not None:
            out += self.resolve_expr(mod, default, mod.scope_of(fn),
                                     depth + 1)
        return out

    # ------------------------------------------------- captured bodies
    def _in_captured(self, mod, node) -> bool:
        p = mod.parents.get(id(node))
        while p is not None:
            if id(p) in self.captured:
                return True
            p = mod.parents.get(id(p))
        return False

    def _roots(self) -> Iterator[Tuple[ModuleSource, ast.AST, ast.AST]]:
        """(module, expression, scope) of each function a program
        captures: the event/sample/body of a Program or StepProgram, and
        what a program stores in its `steps`."""
        for mod in self.mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    chain = mod.attr_chain(node.func)
                    if chain and chain[-1] in ("Program", "StepProgram"):
                        for kw in node.keywords:
                            if kw.arg in ("event", "sample", "body"):
                                yield mod, kw.value, mod.scope_of(node)
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) and isinstance(
                                t.value, ast.Attribute) \
                                and t.value.attr == "steps":
                            yield mod, node.value, mod.scope_of(node)

    def _find_captured(self) -> None:
        def add(targets) -> bool:
            grew = False
            for kind, m, fn in targets:
                if kind == "func" and id(fn) not in self.captured:
                    self.captured[id(fn)] = (m, fn)
                    grew = True
            return grew

        for mod, expr, scope in self._roots():
            add(self.resolve_expr(mod, expr, scope))
        grew = True
        while grew:
            grew = False
            self._memo.clear()      # parameters resolve by what is captured
            for mod, fn in list(self.captured.values()):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        grew |= add(self.resolve_expr(
                            mod, node.func, mod.scope_of(node)))

    def captured_nodes(self) -> Iterator[Tuple[ModuleSource, ast.AST]]:
        """Every node inside a captured body, once."""
        seen: Set[int] = set()
        for mod, fn in self.captured.values():
            for node in ast.walk(fn):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield mod, node


class Checker:
    """Base: subclasses set `name`/`description` and implement `check`
    (per module) or `check_project` (the whole file set at once, as one
    `Project`)."""
    name = "?"
    description = ""
    scope = "module"            # "module" | "project"

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        return iter(())

    def check_project(self, proj: Project) -> Iterator[Finding]:
        return iter(())

    def finding(self, mod: ModuleSource, node: ast.AST, message: str,
                ) -> Finding:
        return Finding(checker=self.name, path=mod.path,
                       line=getattr(node, "lineno", 0), message=message,
                       source=mod.src(node))


# ----------------------------------------------------------------- host-sync
class HostSyncChecker(Checker):
    """Device->host reads where they stall a loop or break a capture.

    Inside a captured body a host read is a capture error (the stream is
    capturing; nothing can be read back) or, where the value is host data
    at capture time, a constant frozen into every replay. In the hot
    packages (`hot_prefixes`) even an uncaptured per-event read is a
    device sync per call: flagged too, so that each one that stays is a
    reviewed, baselined decision (a read once per call, after the loop).
    """
    name = "host-sync"
    description = ("device->host reads (.item()/.tolist()/.cpu()/.numpy(), "
                   "float()/int()/bool() of a computed value) inside a "
                   "captured body anywhere, and in the hot packages")
    scope = "project"

    def __init__(self, hot_prefixes: Sequence[str] = tuple(
            f"src/repro_torch/{p}/" for p in (
                "core", "kernels", "sim", "serve", "obs", "fleet",
                "scenarios"))):
        self.hot_prefixes = tuple(hot_prefixes)

    def check_project(self, proj):
        seen: Set[int] = set()
        for mod, node in proj.captured_nodes():
            msg = self._sync(mod, node)
            if msg:
                seen.add(id(node))
                if not mod.suppressed(node, self.name):
                    yield self.finding(
                        mod, node, msg + " inside a captured body (a "
                        "capture refuses the read, or freezes its value "
                        "into every replay)")
        for mod in proj.mods:
            if not mod.path.startswith(self.hot_prefixes):
                continue
            for node in ast.walk(mod.tree):
                if id(node) in seen:
                    continue
                msg = self._sync(mod, node)
                if msg and not mod.suppressed(node, self.name):
                    yield self.finding(
                        mod, node, msg + " in a hot-path package — a "
                        "device sync per call (keep it on the device, or "
                        "read once after the loop)")

    @staticmethod
    def _sync(mod, node) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_METHODS \
                and not node.args:
            inner = f.value
            if f.attr == "numpy" and isinstance(inner, ast.Call) and \
                    isinstance(inner.func, ast.Attribute) and \
                    inner.func.attr == "cpu":
                return None             # `.cpu()` is the read
            return f"`.{f.attr}()` device read"
        if isinstance(f, ast.Name) and f.id in SCALAR_TYPES and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Subscript):
                chain = mod.attr_chain(arg.value)
                if not (chain and chain[-1] == "shape"):
                    return f"`{f.id}(...)` read of an indexed value"
            if isinstance(arg, ast.Call) and isinstance(arg.func,
                                                        ast.Attribute):
                chain = mod.attr_chain(arg.func)
                receiver_is_module = len(chain) >= 2 and (
                    chain[0] in mod.np_aliases | mod.torch_aliases
                    | {"math", "os", "time", "np", "torch"})
                if arg.func.attr not in HOST_METHODS \
                        and not receiver_is_module:
                    return (f"`{f.id}(...)` read of the result of "
                            f"`.{arg.func.attr}()`")
        return None


# ------------------------------------------------------------ capture-safety
class CaptureSafetyChecker(Checker):
    """Host-to-device copies inside a captured body (the capture rule).

    A CUDA graph's capture refuses a copy from pageable host memory, and
    a copy it did record would replay the capture's host value forever.
    So a captured body makes no tensor from host data (`torch.tensor`,
    `torch.as_tensor`, `torch.from_numpy`: use `torch.full_like` or a
    buffer the program owns) and writes no host scalar into an indexed
    slot (`t[idx] = 0.5` is an `index_put_` of a host tensor: write a
    device tensor, `torch.full_like(...)`).
    """
    name = "capture-safety"
    description = ("host tensors and indexed writes of host scalars inside "
                   "a captured body")
    scope = "project"

    def check_project(self, proj):
        for mod, node in proj.captured_nodes():
            msg = None
            if isinstance(node, ast.Call):
                chain = mod.attr_chain(node.func)
                if len(chain) == 2 and chain[1] in HOST_TENSOR_CTORS and (
                        chain[0] in mod.torch_aliases or chain[0] == "torch"):
                    msg = (f"`{'.'.join(chain)}(...)` makes a tensor from "
                           f"host values inside a captured body (a "
                           f"host-to-device copy the capture refuses; use "
                           f"torch.full_like or a buffer of the program)")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                indexed = any(isinstance(t, ast.Subscript)
                              for tgt in targets for t in ast.walk(tgt))
                if indexed and _host_scalar(mod, node.value,
                                            mod.scope_of(node)):
                    msg = ("a host scalar written into an indexed slot "
                           "inside a captured body (a host-to-device copy "
                           "the capture refuses; write a device tensor, "
                           "torch.full_like(...))")
            if msg and not mod.suppressed(node, self.name):
                yield self.finding(mod, node, msg)


def _host_scalar(mod, expr, scope, depth=0) -> bool:
    """Whether `expr` is a Python number: a literal, float()/int()/bool()
    of anything, arithmetic of such, or a name bound to one (a parameter
    annotated float/int/bool or with a numeric default, or a local
    assigned one)."""
    if depth > MAX_DEPTH:
        return False
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (bool, int, float))
    if isinstance(expr, ast.UnaryOp):
        return _host_scalar(mod, expr.operand, scope, depth + 1)
    if isinstance(expr, ast.BinOp):
        return _host_scalar(mod, expr.left, scope, depth + 1) and \
            _host_scalar(mod, expr.right, scope, depth + 1)
    if isinstance(expr, ast.Call):
        return isinstance(expr.func, ast.Name) and \
            expr.func.id in SCALAR_TYPES
    if not isinstance(expr, ast.Name):
        return False
    s = scope
    while True:
        if s is not None:
            for p in _params(s):
                if p.arg == expr.id:
                    ann = p.annotation
                    if isinstance(ann, ast.Name) and ann.id in SCALAR_TYPES:
                        return True
                    d = _default_of(s, expr.id)
                    return d is not None and isinstance(d, ast.Constant) \
                        and isinstance(d.value, (int, float)) \
                        and not isinstance(d.value, bool)
        values, bound = [], False
        for node in _own_nodes(s if s is not None else mod.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in node.targets):
                values.append(node.value)
            elif _binds(node, expr.id):
                bound = True
        if values:
            return all(_host_scalar(mod, v, s, depth + 1) for v in values)
        if bound or s is None:
            return False
        s = mod.scope_of(s)


# --------------------------------------------------------------- dtype-drift
class DtypeDriftChecker(Checker):
    """Array and tensor constructors without an explicit dtype in arena and
    training code.

    The arenas are padded, stacked and compared bitwise across devices
    and against the JAX package; a constructor that picks numpy's float64
    (`np.full(N, 8.0)`), torch's default dtype (which a caller may
    change) or the fill value's Python type is a latent numerics change.
    `array`/`asarray`/`tensor` and the `*_like` forms are exempt (they
    carry their input's dtype)."""
    name = "dtype-drift"
    description = ("np/torch zeros/ones/full/empty/arange without an "
                   "explicit dtype in arena and training code")

    def __init__(self, prefixes: Sequence[str] = tuple(
            f"src/repro_torch/{p}/" for p in ("core", "train", "kernels"))):
        self.prefixes = tuple(prefixes)

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if not mod.path.startswith(self.prefixes):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = mod.attr_chain(node.func)
            if len(chain) != 2 or chain[1] not in DTYPE_REQUIRED:
                continue
            if chain[0] in mod.np_aliases:
                if len(node.args) > NP_DTYPE_POSITION[chain[1]]:
                    continue
            elif chain[0] not in mod.torch_aliases:
                continue
            if any(kw.arg == "dtype" or kw.arg is None and _dict_has_dtype(
                    mod, kw.value, mod.scope_of(node))
                    for kw in node.keywords):
                continue
            if mod.suppressed(node, self.name):
                continue
            yield self.finding(
                mod, node,
                f"`{'.'.join(chain)}(...)` without an explicit dtype in "
                f"arena or training code — the default is a policy choice "
                f"(pass dtype=...)")


def _dict_has_dtype(mod, expr, scope) -> bool:
    """Whether `**expr` passes a dtype: a dict display or `dict(...)` with
    a "dtype" entry, or a name assigned one in an enclosing scope."""
    if isinstance(expr, ast.Dict):
        return any(isinstance(k, ast.Constant) and k.value == "dtype"
                   for k in expr.keys)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id == "dict":
        return any(kw.arg == "dtype" for kw in expr.keywords)
    if not isinstance(expr, ast.Name):
        return False
    s = scope
    while True:
        values = [n.value for n in _own_nodes(s if s is not None
                                              else mod.tree)
                  if isinstance(n, ast.Assign) and any(
                      isinstance(t, ast.Name) and t.id == expr.id
                      for t in n.targets)]
        if values:
            return all(_dict_has_dtype(mod, v, s) for v in values)
        if s is None:
            return False
        s = mod.scope_of(s)


# ------------------------------------------------------ fingerprint-coverage
class FingerprintCoverageChecker(Checker):
    """Output-relevant config fields missing from every cache key.

    The port's result cache, dataset store and compiled programs are only
    right if their keys capture every input that changes what they hold
    (`SimRequest.content_hash`, `Backend.fingerprint`, `train.data.
    shard_key`, `TrainState.weights_hash`). For each configured
    dataclass, every field must be referenced by some fingerprint-family
    function (by attribute or string name), or the class must be
    serialized wholesale there (repr/asdict/astuple/fields/tree_digest
    on a matching receiver). The JAX package's rule, on the port's
    classes."""
    name = "fingerprint-coverage"
    description = ("dataclass fields of cache-identity classes not "
                   "reflected in any fingerprint/content_hash/shard_key "
                   "implementation")
    scope = "project"

    FINGERPRINT_FUNCS = {"fingerprint", "content_hash", "result_key",
                         "shard_key", "dataset_key", "weights_hash"}
    WHOLESALE_FUNCS = {"repr", "asdict", "astuple", "fields", "tree_digest"}
    # class -> receiver-name fragments that tie a wholesale call to it
    CLASSES = {
        "M4Config": ("cfg", "m4cfg"),
        "SimRequest": ("request", "req"),
        "NetConfig": ("NetConfig", "config"),
    }

    def check_project(self, proj):
        fields = self._class_fields(proj.mods)
        bodies = [fn for mod in proj.mods for fn in ast.walk(mod.tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and fn.name in self.FINGERPRINT_FUNCS]
        if not bodies:
            return
        attrs: Set[str] = set()
        strings: Set[str] = set()
        wholesale: List[str] = []
        for fn in bodies:
            a, s, w = self._body_refs(fn)
            attrs |= a
            strings |= s
            wholesale += w
        for cls, (mod, names) in fields.items():
            ties = self.CLASSES.get(cls, ())
            has_wholesale = any(t in w for w in wholesale for t in ties)
            for fname, fnode in names:
                if fname in attrs or fname in strings or has_wholesale:
                    continue
                if mod.suppressed(fnode, self.name):
                    continue
                yield self.finding(
                    mod, fnode,
                    f"field {cls}.{fname} is never referenced by any "
                    f"fingerprint/content-hash implementation "
                    f"({', '.join(sorted(self.FINGERPRINT_FUNCS))}) — "
                    f"if it changes simulator output or a compiled "
                    f"program, cached results can alias across values")

    def _class_fields(self, mods):
        out = {}
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) \
                        and node.name in self.CLASSES:
                    names = []
                    for stmt in node.body:
                        if isinstance(stmt, ast.AnnAssign) \
                                and isinstance(stmt.target, ast.Name) \
                                and "ClassVar" not in ast.unparse(
                                    stmt.annotation):
                            names.append((stmt.target.id, stmt))
                    out[node.name] = (mod, names)
        return out

    def _body_refs(self, fn):
        """(attribute names, string constants, wholesale-call arg texts)
        referenced by a fingerprint body, docstring excluded."""
        attrs: Set[str] = set()
        strings: Set[str] = set()
        wholesale: List[str] = []
        body = list(fn.body)
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            body = body[1:]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Attribute):
                    attrs.add(node.attr)
                elif isinstance(node, ast.Name):
                    attrs.add(node.id)
                elif isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    strings.add(node.value)
                elif isinstance(node, ast.Call):
                    f = node.func
                    while isinstance(f, ast.Attribute):
                        if f.attr in self.WHOLESALE_FUNCS and node.args:
                            wholesale.append(ast.unparse(node.args[0]))
                        f = f.value
                    if isinstance(f, ast.Name) \
                            and f.id in self.WHOLESALE_FUNCS and node.args:
                        wholesale.append(ast.unparse(node.args[0]))
        return attrs, strings, wholesale


# ------------------------------------------------------------ retrace-hazard
class RetraceHazardChecker(Checker):
    """Compiled programs keyed or built where they replay the wrong work.

    (a) A `compiled.run(...)`, a `StepCache(...)` or a
        `torch.cuda.CUDAGraph()` made inside a `for`/`while` body: a
        fresh cache or graph per iteration captures afresh each time (the
        counterpart of a `jax.jit` built in a loop), and a `build`
        closure over the loop's variables is run only for the first
        iteration whose key matches.
    (b) A `compiled.run(counts, name, key, device, build, *args)` whose
        `key` leaves out a non-tensor input that shapes the program:
        a name the `build` closure reads from the calling function, or a
        plain name passed in `args`, that is (or is computed from) an
        annotated or defaulted parameter or a shape, and is not in the
        key. A second call with another value would replay the first
        call's program. Unannotated parameters without a default are the
        call's tensors (their values are copied into the program on every
        call) and need no key.
    """
    name = "retrace-hazard"
    description = ("compiled programs or graphs made in loops; compiled.run "
                   "keys that leave out an input of the program")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        yield from self._in_loops(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and self._is_run(mod, node):
                yield from self._key_coverage(mod, node)

    @staticmethod
    def _is_run(mod, call) -> bool:
        chain = mod.attr_chain(call.func)
        return chain[-2:] == ["compiled", "run"] and len(call.args) >= 5

    def _made_in_loop(self, mod, call) -> Optional[str]:
        chain = mod.attr_chain(call.func)
        if not chain:
            return None
        if chain[-1] == "CUDAGraph" and len(chain) >= 2:
            return "torch.cuda.CUDAGraph()"
        if chain[-1] == "StepCache":
            return "StepCache(...)"
        if chain[-2:] == ["compiled", "run"]:
            return "compiled.run(...)"
        return None

    def _in_loops(self, mod) -> Iterator[Finding]:
        seen: Set[int] = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            stack = list(loop.body)
            while stack:
                node = stack.pop()
                if isinstance(node, SCOPES):
                    continue            # a body defined, not run, per turn
                stack.extend(ast.iter_child_nodes(node))
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                what = self._made_in_loop(mod, node)
                if what and not mod.suppressed(node, self.name):
                    seen.add(id(node))
                    yield self.finding(
                        mod, node,
                        f"{what} made inside a loop body — each iteration "
                        f"captures or keys afresh (hoist it out of the "
                        f"loop, or make one per shape on purpose and say "
                        f"so)")

    def _key_coverage(self, mod, call) -> Iterator[Finding]:
        fn = mod.scope_of(call)
        if fn is None or isinstance(fn, ast.Lambda):
            return
        key_names = self._key_names(mod, call.args[2], fn)
        if key_names is None:
            return
        build = self._build_fn(mod, call.args[4], fn)
        cands: List[str] = []
        if build is not None:
            cands += sorted(_free_names(build))
        cands += [a.id for a in call.args[5:] if isinstance(a, ast.Name)]
        missing: Dict[str, Set[str]] = {}
        for name in cands:
            roots = self._uncovered(fn, name, key_names, set())
            if roots:
                missing[name] = roots
        if missing and not mod.suppressed(call, self.name):
            parts = [n if roots == {n} else
                     f"{', '.join(sorted(roots))} (through {n})"
                     for n, roots in sorted(missing.items())]
            yield self.finding(
                mod, call,
                f"compiled.run key leaves out {'; '.join(parts)}, which "
                f"shapes the program that `build` makes — a call with "
                f"another value would replay the first call's program "
                f"(add it to the key)")

    @staticmethod
    def _key_names(mod, expr, fn) -> Optional[Set[str]]:
        if isinstance(expr, ast.Name):
            vals = [n.value for n in _own_nodes(fn)
                    if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in n.targets)]
            if len(vals) != 1:
                return None
            expr = vals[0]
        if not isinstance(expr, ast.Tuple):
            return None
        return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}

    @staticmethod
    def _build_fn(mod, expr, fn):
        if isinstance(expr, ast.Lambda):
            return expr
        if isinstance(expr, ast.Name):
            for n in _own_nodes(fn):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and n.name == expr.id:
                    return n
        return None

    def _uncovered(self, fn, name, key_names, seen) -> Set[str]:
        """The non-tensor inputs of `fn` that `name` depends on and the key
        leaves out (empty: covered, a tensor, or not `fn`'s own name)."""
        if name in key_names or name in seen:
            return set()
        seen.add(name)
        for p in _params(fn):
            if p.arg == name:
                shaped = p.annotation is not None or \
                    _default_of(fn, name) is not None
                return {name} if shaped else set()
        values = []
        for n in _own_nodes(fn):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                if any(_binds(t, name) for tgt in targets
                       for t in ast.walk(tgt)) and n.value is not None:
                    values.append(n.value)
        if not values:
            return set()
        out: Set[str] = set()
        for v in values:
            if any(isinstance(x, ast.Attribute) and x.attr == "shape"
                   or isinstance(x, ast.Call) and isinstance(x.func, ast.Name)
                   and x.func.id == "len" for x in ast.walk(v)):
                return {name}           # a shape: it must be keyed itself
            for x in ast.walk(v):
                if isinstance(x, ast.Name) and isinstance(x.ctx, ast.Load):
                    out |= self._uncovered(fn, x.id, key_names, seen)
        return out


def _free_names(fn) -> Set[str]:
    """Names a function reads but does not bind itself (its closure and
    globals)."""
    bound = {p.arg for p in _params(fn)}
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                bound.add(node.id)
            else:
                loads.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            bound.add(node.name)
        elif isinstance(node, ast.arg):
            bound.add(node.arg)
    return loads - bound


def default_checkers() -> List[Checker]:
    return [HostSyncChecker(), CaptureSafetyChecker(), DtypeDriftChecker(),
            FingerprintCoverageChecker(), RetraceHazardChecker()]
