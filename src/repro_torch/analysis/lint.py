"""AST contract linter over ``src/repro_torch`` (pure ``ast`` and ``re``).

The port's counterpart of the reference's ``repro.analysis.lint``, driven
by :mod:`repro_torch.analysis.registry`.  Five rule families:

* **single compute site** (``duplicate-compute-site``,
  ``missing-definition``): the paper-level operations with one registered
  home, in the forms the port writes them: the tracking combine
  (``torch.sub(a + b, prev)``, ``(a + b) - prev``, ``.sub(prev)`` /
  ``.sub_(prev)``), a direct ``torch.linalg.qr`` (``np.linalg.qr`` only
  in the registered data generators), a wire round trip
  (``.to(torch.bfloat16).to(...)``, float8 and int8 alike), and a
  module-level ``def`` or assignment of a reserved name.  The CUDA
  sources' copies of a site are registered by file and device function: a
  ``.cu``/``.cuh`` that defines one unregistered fails, and so does a
  registered file that no longer holds it.  A registered definition or
  public binding that disappears fails too (registry rot).
* **bare-assert**: anywhere in the port (``python -O`` strips asserts).
* **env-config**: ``os.environ`` / ``os.getenv`` access to a port
  variable (a ``runtime/config.py`` name or one with its prefix) outside
  ``runtime/config.py``.
* **host-sync**: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``np.asarray`` of a tensor, ``float`` / ``int`` / ``bool`` of a tensor
  name, and ``synchronize`` calls inside a registered hot region (the
  driver's iteration loops, ``PowerStep.__call__``, the engines' gossip
  calls), unless registered as a deliberate host decision.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import registry
from .report import PassResult

#: Leaf names whose subtraction marks Eqn. (3.1) tracking arithmetic.
_PREV_LIKE = re.compile(r"(?i)^(g|p|w|s)?_?prev$|^gp$")
#: Leaf names of a wire dtype (a cast to one, then back, is a round trip).
_WIRE_LIKE = re.compile(r"(?i)bfloat16|bf16|float8|fp8|int8")
#: Methods that cast a tensor, and those that copy it to the host.
_CASTS = {"to", "type", "float", "double", "half", "bfloat16"}
_HOST_METHODS = {"item", "cpu", "tolist", "numpy"}
_NP_ROOTS = {"np", "numpy"}
_ENV_CALLS = {("os", "environ", "get"), ("os", "environ", "pop"),
              ("os", "environ", "setdefault"), ("os", "getenv"),
              ("os", "putenv"), ("os", "unsetenv")}
_CUDA_SUFFIXES = (".cu", ".cuh")


def _leaf_name(node: ast.AST) -> Optional[str]:
    """Rightmost identifier of a Name/Attribute/Subscript chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _leaf_name(node.value)
    return None


def _attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for non-pure chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_add(node: ast.AST) -> bool:
    """``a + b``, ``torch.add(a, b)`` or ``a.add(b)`` / ``a.add_(b)``."""
    if isinstance(node, ast.BinOp):
        return isinstance(node.op, ast.Add)
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr in ("add", "add_")


def _prev_like(node: Optional[ast.AST]) -> Optional[str]:
    name = _leaf_name(node) if node is not None else None
    return name if name and _PREV_LIKE.match(name) else None


def _cast_target(call: ast.Call) -> Optional[str]:
    """The dtype leaf a cast call names (``.to(torch.bfloat16)``,
    ``.to(dtype=...)``, ``.bfloat16()``), else None."""
    if not isinstance(call.func, ast.Attribute) or \
            call.func.attr not in _CASTS:
        return None
    if call.func.attr in ("float", "double", "half", "bfloat16"):
        return call.func.attr
    for arg in list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "dtype"]:
        name = _leaf_name(arg)
        if name and name != "device":
            return name
    return None


def _annotation_is_tensor(ann: Optional[ast.AST]) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


class _Function:
    """One function on the lexical stack: its qualified name, whether it
    is (inside) a hot region, and the names it binds to tensors."""

    def __init__(self, qualname: str, node, hot: Optional[
            registry.HotRegion]) -> None:
        self.qualname = qualname
        self.hot = hot
        self.loops = 0
        self.tensors = _tensor_names(node)


def _tensor_names(node) -> Set[str]:
    """Parameters annotated as tensors, and the locals the function binds
    to a torch expression (``torch.*`` calls, a tensor's methods, binary
    operations and subscripts of tensors), to a fixed point."""
    args = node.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
             if _annotation_is_tensor(a.annotation)}

    def tensor_valued(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in names
        if isinstance(expr, ast.Subscript):
            return tensor_valued(expr.value)
        if isinstance(expr, ast.BinOp):
            return tensor_valued(expr.left) or tensor_valued(expr.right)
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain and chain[0] == "torch":
                return True
            return isinstance(expr.func, ast.Attribute) and \
                tensor_valued(expr.func.value)
        return False

    assigns = [n for n in ast.walk(node) if isinstance(n, ast.Assign)]
    while True:
        before = len(names)
        for a in assigns:
            if tensor_valued(a.value):
                for t in a.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        if len(names) == before:
            return names


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, result: PassResult,
                 fixture: bool) -> None:
        self.relpath = relpath.replace(os.sep, "/")
        self.result = result
        self.fixture = fixture
        self.stack: List[str] = []            # class / function names
        self.functions: List[_Function] = []
        self.defs: Set[Tuple[str, str]] = set()
        self.bindings: Set[Tuple[str, str, str]] = set()

    # ----------------------------------------------------------- helpers
    def _enclosing(self) -> str:
        return self.functions[-1].qualname if self.functions else "<module>"

    def _site(self, pattern: str) -> registry.ComputeSite:
        for site in registry.COMPUTE_SITES:
            if site.pattern == pattern:
                return site
        raise KeyError(pattern)

    def _inside(self, allowed) -> bool:
        # a match anywhere lexically inside a registered function counts as
        # that site (its nested helpers and lambdas included)
        return any((self.relpath, name) in allowed for name in self.stack)

    def _flag_site(self, site: registry.ComputeSite, node: ast.AST,
                   what: str) -> None:
        self.result.add(
            "duplicate-compute-site", self.relpath, node.lineno,
            f"{what} in {self._enclosing()}() duplicates the "
            f"'{site.name}' compute site — {site.doc}")

    def _hot_region(self, qualname: str) -> Optional[registry.HotRegion]:
        for region in registry.HOT_REGIONS:
            if region.qualname == qualname and \
                    (self.fixture or region.path == self.relpath):
                return region
        return None

    # ----------------------------------------------------------- scopes
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        if not self.stack:
            self.defs.add((self.relpath, node.name))
            self._check_reserved(node, node.name)
        self.stack.append(node.name)
        qualname = ".".join(self.stack)
        outer = self.functions[-1] if self.functions else None
        own = self._hot_region(qualname)
        fn = _Function(qualname, node,
                       own or (outer.hot if outer is not None else None))
        if own is None and outer is not None and outer.hot is not None:
            fn.loops = outer.loops          # a closure inside the hot code
            fn.tensors |= outer.tensors
        self.functions.append(fn)
        self.generic_visit(node)
        self.functions.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node) -> None:
        if self.functions:
            self.functions[-1].loops += 1
        self.generic_visit(node)
        if self.functions:
            self.functions[-1].loops -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def _check_reserved(self, node: ast.AST, name: str) -> None:
        homes = registry.RESERVED_DEFS.get(name)
        if homes is not None and self.relpath not in homes:
            self.result.add(
                "duplicate-compute-site", self.relpath, node.lineno,
                f"re-definition of reserved seam function '{name}' "
                f"(registered home(s): {', '.join(homes)})")

    def visit_Assign(self, node: ast.Assign) -> None:
        if not self.stack:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._check_reserved(node, target.id)
                    if isinstance(node.value, ast.Name):
                        self.bindings.add((self.relpath, target.id,
                                           node.value.id))
        self.generic_visit(node)

    # ------------------------------------------------------------ asserts
    def visit_Assert(self, node: ast.Assert) -> None:
        self.result.add(
            "bare-assert", self.relpath, node.lineno,
            f"bare assert in {self._enclosing()}() — `python -O` strips it; "
            "raise ValueError (validate_* style) instead")
        self.generic_visit(node)

    # ----------------------------------------------------------- tracking
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Sub) and _is_add(node.left):
            prev = _prev_like(node.right)
            if prev:
                self._tracking(node, f"tracking arithmetic `(... + ...) - "
                                     f"{prev}`")
        self.generic_visit(node)

    def _tracking(self, node: ast.AST, what: str) -> None:
        site = self._site("tracking")
        if not self._inside(site.allowed):
            self._flag_site(site, node, what)

    def _check_tracking_call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain in (("torch", "sub"), ("torch", "subtract")) and \
                len(node.args) >= 2 and _is_add(node.args[0]):
            prev = _prev_like(node.args[1])
            if prev:
                self._tracking(node, f"tracking arithmetic "
                                     f"`torch.sub(... + ..., {prev})`")
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("sub", "sub_", "subtract") and node.args:
            prev = _prev_like(node.args[0])
            recv = node.func.value
            if prev and (_is_add(recv) or (node.func.attr == "sub_"
                                           and isinstance(recv, ast.Name))):
                self._tracking(node, f"tracking arithmetic "
                                     f"`.{node.func.attr}({prev})`")

    # -------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        self._check_tracking_call(node)
        self._check_qr(node)
        self._check_wire_roundtrip(node)
        self._check_env_call(node)
        self._check_host_sync(node)
        self.generic_visit(node)

    def _check_qr(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if not chain:
            return
        site = self._site("linalg-qr")
        if chain in (("torch", "linalg", "qr"), ("torch", "qr")):
            if not self._inside(site.allowed):
                self._flag_site(site, node, f"direct {'.'.join(chain)} call")
        elif chain[-2:] == ("linalg", "qr") and chain[0] in _NP_ROOTS:
            if not self._inside(site.allowed | registry.DATA_QR_ALLOWED):
                self._flag_site(site, node, f"{'.'.join(chain)} outside the "
                                            "registered data generators")

    def _check_wire_roundtrip(self, node: ast.Call) -> None:
        if not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in _CASTS:
            return
        inner = node.func.value
        if not isinstance(inner, ast.Call):
            return
        target = _cast_target(inner)
        if target and _WIRE_LIKE.search(target):
            site = self._site("wire-roundtrip")
            if not self._inside(site.allowed):
                self._flag_site(site, node,
                                f"wire-dtype round trip through '{target}'")

    # --------------------------------------------------------- env-config
    def _port_key(self, node: Optional[ast.AST]) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if v in registry.ENV_NAMES or \
                    v.startswith(registry.ENV_NAME_PREFIX):
                return repr(v)
            return None
        name = _leaf_name(node) if node is not None else None
        if name and name.startswith("ENV_"):
            return name
        return None

    def _flag_env(self, node: ast.AST, what: str) -> None:
        if self.relpath in registry.ENV_CONFIG_ALLOWED:
            return
        self.result.add(
            "env-config", self.relpath, node.lineno,
            f"{what} in {self._enclosing()}() — the port's environment "
            "variables belong to repro_torch/runtime/config.py: read "
            "runtime.config.get_config(), set them with configure()")

    def _check_env_call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain in _ENV_CALLS:
            key = self._port_key(node.args[0] if node.args else None)
            if key is not None:
                self._flag_env(node, f"{'.'.join(chain)}({key})")
        elif chain == ("os", "environ", "update") and node.args and \
                isinstance(node.args[0], ast.Dict):
            for k in node.args[0].keys:
                key = self._port_key(k)
                if key is not None:
                    self._flag_env(node, f"os.environ.update({key}: ...)")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if _attr_chain(node.value) == ("os", "environ"):
            key = self._port_key(node.slice)
            if key is not None:
                self._flag_env(node, f"os.environ[{key}]")
        self.generic_visit(node)

    # ---------------------------------------------------------- host sync
    def _check_host_sync(self, node: ast.Call) -> None:
        fn = self.functions[-1] if self.functions else None
        if fn is None or fn.hot is None or \
                (fn.hot.loops_only and fn.loops == 0):
            return
        what = None
        chain = _attr_chain(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_METHODS:
            what = f".{node.func.attr}() copies to the host"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "synchronize":
            what = f"{ast.unparse(node.func)}() waits for the card"
        elif chain and chain[0] in _NP_ROOTS and \
                chain[-1] in ("asarray", "array") and node.args and \
                _leaf_name(node.args[0]) in fn.tensors:
            what = f"{'.'.join(chain)}() of a tensor copies to the host"
        elif isinstance(node.func, ast.Name) and \
                node.func.id in ("float", "int", "bool") and \
                len(node.args) == 1 and \
                isinstance(node.args[0], (ast.Name, ast.Subscript)) and \
                _leaf_name(node.args[0]) in fn.tensors:
            what = (f"{node.func.id}({ast.unparse(node.args[0])}) of a "
                    "tensor reads it on the host")
        if what is None:
            return
        key = (fn.hot.path, fn.hot.qualname, ast.unparse(node))
        if key in registry.HOST_SYNC_ALLOWED:
            return
        self.result.add(
            "host-sync", self.relpath, node.lineno,
            f"{what} inside {fn.hot.qualname} ({fn.hot.doc}): it stalls the "
            "card once per iteration; keep the value on the device, or "
            "register the decision in registry.HOST_SYNC_ALLOWED with its "
            "reason")


def iter_source_files(root: str) -> Iterable[Tuple[str, str]]:
    """``(relpath, abspath)`` of every ``.py`` and CUDA source under
    ``root``."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if fn.endswith((".py",) + _CUDA_SUFFIXES):
                ap = os.path.join(dirpath, fn)
                yield os.path.relpath(ap, root).replace(os.sep, "/"), ap


def lint_file(relpath: str, abspath: str, result: PassResult,
              fixture: bool = False):
    """Lint one Python file into ``result``; returns the ``(relpath,
    def)`` set and the ``(relpath, name, value)`` module-level bindings."""
    with open(abspath) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=abspath)
    except SyntaxError as e:
        result.add("syntax-error", relpath, e.lineno or 0, str(e))
        return set(), set()
    linter = _Linter(relpath, result, fixture)
    linter.visit(tree)
    return linter.defs, linter.bindings


# ------------------------------------------------------------ CUDA sources
_C_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def c_definitions(text: str, names: Iterable[str]) -> Dict[str, int]:
    """The names among ``names`` that a CUDA source defines (a
    ``__device__`` or ``__global__`` declaration), each with its line."""
    code = _C_COMMENTS.sub(lambda m: re.sub(r"[^\n]", " ", m.group()), text)
    found: Dict[str, int] = {}
    for name in names:
        for m in re.finditer(rf"\b{re.escape(name)}\s*\(", code):
            start = max(code.rfind(";", 0, m.start()),
                        code.rfind("}", 0, m.start()),
                        code.rfind("{", 0, m.start()))
            head = code[start + 1:m.start()]
            if re.search(r"\b__(device|global)__\b", head):
                found.setdefault(name, code.count("\n", 0, m.start()) + 1)
                break
    return found


def lint_cuda(relpath: str, abspath: str, result: PassResult) -> Set[
        Tuple[str, str]]:
    """Flag a registered mirror function defined in an unregistered CUDA
    file; returns the ``(relpath, function)`` mirrors the file defines."""
    with open(abspath) as f:
        text = f.read()
    registered = {(m.path, m.function): m for m in registry.MIRRORS}
    sites = {m.function: m.site for m in registry.MIRRORS}
    found = c_definitions(text, sites)
    for name, line in sorted(found.items()):
        if (relpath, name) not in registered:
            result.add(
                "duplicate-compute-site", relpath, line,
                f"{name}() is an in-kernel mirror of the '{sites[name]}' "
                f"compute site, not registered for this file — register it "
                "in repro_torch/analysis/registry.py MIRRORS or call the "
                "registered one")
    return {(relpath, name) for name in found}


def run(files: Optional[Sequence[str]] = None,
        src_root: Optional[str] = None) -> PassResult:
    """Lint the port's tree (default) or an explicit file list.

    With explicit ``files`` (fixture mode) paths are keyed by basename, so
    nothing matches a registered compute site or mirror file, hot regions
    match on their qualified names alone, and the registered-definition
    checks are skipped.
    """
    result = PassResult(name="lint")
    fixture = files is not None
    if fixture:
        entries = [(os.path.basename(f), f) for f in files]
    else:
        entries = list(iter_source_files(src_root or registry.SRC_ROOT))
    defs: Set[Tuple[str, str]] = set()
    bindings: Set[Tuple[str, str, str]] = set()
    mirrors: Set[Tuple[str, str]] = set()
    for rel, ap in entries:
        if rel.endswith(_CUDA_SUFFIXES):
            mirrors |= lint_cuda(rel, ap, result)
        else:
            d, b = lint_file(rel, ap, result, fixture)
            defs |= d
            bindings |= b
        result.checked += 1
    if fixture:
        return result
    for site in registry.COMPUTE_SITES:
        path, fn = site.definition
        if site.definition not in defs:
            result.add(
                "missing-definition", path, 0,
                f"registered compute site '{site.name}' definition {fn}() "
                "not found — update repro_torch/analysis/registry.py")
        elif site.binding and (path, site.binding, fn) not in bindings:
            result.add(
                "missing-definition", path, 0,
                f"registered compute site '{site.name}': the public binding "
                f"`{site.binding} = {fn}` is gone — the seam's public name "
                "is part of the site")
    for m in registry.MIRRORS:
        if (m.path, m.function) not in mirrors:
            result.add(
                "missing-definition", m.path, 0,
                f"registered in-kernel mirror {m.function}() of "
                f"'{m.site}' not found in {m.path} — update "
                "repro_torch/analysis/registry.py MIRRORS")
    return result
