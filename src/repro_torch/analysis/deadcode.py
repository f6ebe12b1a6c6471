"""Import-graph reachability over ``src/repro_torch`` — the deadcode report.

The reference's reachability (``repro.analysis.deadcode``), parametrised
by the package's name, its entry points, its auxiliary roots and its
quarantine.  It builds the static import graph (AST: ``import`` and
``from``-imports, module-level and lazy function-local ones, and the
``importlib.import_module("pkg.prefix...")`` idiom) and classifies every
module:

* **runtime** — reachable from :data:`registry.ENTRY_POINTS`;
* **aux** — unreachable from them but imported by ``tests/``,
  ``examples/``, ``scripts/`` or ``chip_smoke.py``
  (:data:`registry.AUX_ROOTS`): it FAILS unless quarantined in
  :data:`registry.DEADCODE_QUARANTINE` with its reason;
* **orphan** — reachable from nothing: FAILS (delete it or wire it up);
* **stale-quarantine** — quarantined but runtime-reachable, or gone:
  FAILS (the list must not rot).

A quarantine entry covers the module and everything only it reaches; the
pass lists each quarantined module in its notes (a recorded decision, not
a skipped check).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, Optional, Sequence, Set

from . import registry
from .report import PassResult


def _iter_modules(src_root: str, pkg: str) -> Dict[str, str]:
    """dotted module name -> absolute path, for every module of ``pkg``."""
    out = {}
    pkg_root = os.path.join(src_root, pkg)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in filenames:
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            parts = os.path.relpath(full, src_root)[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out[".".join(parts)] = full
    return out


def _fstring_prefix(arg: ast.JoinedStr, module: str) -> Optional[str]:
    """The literal head of an f-string module name: its leading constants,
    with ``{__name__}`` read as the importing module's own name (the
    ``import_module(f"{__name__}.{arch}")`` registry idiom)."""
    head = ""
    for part in arg.values:
        if isinstance(part, ast.Constant):
            head += str(part.value)
        elif isinstance(part, ast.FormattedValue) and \
                isinstance(part.value, ast.Name) and \
                part.value.id == "__name__":
            head += module
        else:
            break
    return head or None


def _imports_of(path: str, module: str, known: Set[str],
                pkg: str) -> Set[str]:
    """Modules of ``pkg`` that ``module`` imports (eager or lazy)."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            return set()
    is_pkg = path.endswith("__init__.py")
    pkg_parts = module.split(".") if is_pkg else module.split(".")[:-1]
    found: Set[str] = set()

    def _add(dotted: str, names: Iterable[str] = ()) -> None:
        if not (dotted == pkg or dotted.startswith(pkg + ".")):
            return
        if dotted in known:
            found.add(dotted)
        for n in names:          # `from pkg import name`, name a module
            child = f"{dotted}.{n}"
            if child in known:
                found.add(child)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                _add(alias.name)
        elif isinstance(node, ast.Call):
            fn = node.func
            is_imp = ((isinstance(fn, ast.Attribute)
                       and fn.attr == "import_module")
                      or (isinstance(fn, ast.Name)
                          and fn.id == "import_module"))
            if is_imp and node.args:
                arg = node.args[0]
                prefix = None
                if isinstance(arg, ast.JoinedStr):
                    prefix = _fstring_prefix(arg, module)
                elif isinstance(arg, ast.Constant):
                    prefix = str(arg.value)
                if prefix:
                    found.update(m for m in known if m.startswith(prefix))
        elif isinstance(node, ast.ImportFrom):
            if node.level:      # relative: resolve against this package
                base = pkg_parts[:len(pkg_parts) - node.level + 1]
                dotted = ".".join(base + (node.module or "").split(".")
                                  ).rstrip(".")
            else:
                dotted = node.module or ""
            _add(dotted, [a.name for a in node.names])
    found.discard(module)
    return found


def _aux_roots(repo_root: str, known: Set[str], pkg: str,
               roots: Sequence[str]) -> Dict[str, Set[str]]:
    """Modules imported by the auxiliary roots -> the importing files."""
    out: Dict[str, Set[str]] = {}

    def scan(full: str) -> None:
        rel = os.path.relpath(full, repo_root)
        for mod in _imports_of(full, f"__aux__.{rel}", known, pkg):
            out.setdefault(mod, set()).add(rel)

    for sub in roots:
        base = os.path.join(repo_root, sub)
        if os.path.isfile(base) and base.endswith(".py"):
            scan(base)
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in filenames:
                if fname.endswith(".py"):
                    scan(os.path.join(dirpath, fname))
    return out


def _closure(roots: Iterable[str], edges: Dict[str, Set[str]],
             known: Set[str]) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in known]
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # entering a module implies importing its ancestor packages
        parts = mod.split(".")
        for i in range(1, len(parts)):
            anc = ".".join(parts[:i])
            if anc in known and anc not in seen:
                stack.append(anc)
        stack.extend(edges.get(mod, ()))
    return seen


def analyze(src_root: Optional[str] = None, repo_root: Optional[str] = None,
            *, pkg: str = registry.PACKAGE,
            entry_points: Optional[Sequence[str]] = None,
            aux_roots: Optional[Sequence[str]] = None,
            quarantine: Optional[Iterable[str]] = None) -> dict:
    """Full reachability report (the CLI renders / json-dumps this).

    ``src_root`` is the directory holding the package (default: the
    port's ``src``), ``repo_root`` the one holding the auxiliary roots;
    the rest default to the registry's.
    """
    if src_root is None:
        src_root = os.path.dirname(registry.SRC_ROOT)
        repo_root = repo_root or registry.REPO_ROOT
    repo_root = repo_root or os.path.dirname(src_root)
    entry_points = registry.ENTRY_POINTS if entry_points is None \
        else tuple(entry_points)
    aux_roots = registry.AUX_ROOTS if aux_roots is None else tuple(aux_roots)
    quarantine = tuple(registry.DEADCODE_QUARANTINE if quarantine is None
                       else quarantine)
    modules = _iter_modules(src_root, pkg)
    known = set(modules)
    edges = {mod: _imports_of(path, mod, known, pkg)
             for mod, path in sorted(modules.items())}

    # a package entry point runs as `python -m pkg`: its __main__ too
    roots = [ep for e in entry_points for ep in (e, f"{e}.__main__")]
    runtime = _closure(roots, edges, known)
    aux_imports = _aux_roots(repo_root, known, pkg, aux_roots)
    aux = _closure(aux_imports, edges, known) - runtime
    orphan = known - runtime - aux
    quarantined = _closure(quarantine, edges, known) - runtime
    return {
        "modules": sorted(known),
        "runtime": sorted(runtime),
        "aux": sorted(aux),
        "orphan": sorted(orphan),
        "quarantined": sorted(quarantined),
        "aux_importers": {m: sorted(files)
                          for m, files in sorted(aux_imports.items())
                          if m in aux},
        "stale_quarantine": sorted(
            m for m in quarantine if m in runtime or m not in known),
    }


def run(src_root: Optional[str] = None,
        repo_root: Optional[str] = None) -> PassResult:
    result = PassResult(name="deadcode")
    rep = analyze(src_root, repo_root)
    result.checked = len(rep["modules"])
    quarantine = set(rep["quarantined"])
    reasons = registry.DEADCODE_QUARANTINE

    for mod in rep["orphan"]:
        if mod in quarantine:
            result.notes.append(f"{mod}: orphan, quarantined")
            continue
        result.add("orphan-module", mod, 0,
                   "reachable from no entry point, test, example, script or "
                   "the smoke run — delete it or add it to "
                   "DEADCODE_QUARANTINE with a reason")
    for mod in rep["aux"]:
        if mod in quarantine:
            why = reasons.get(mod, "reached only through a quarantined "
                                   "module")
            result.notes.append(f"{mod}: aux-only, quarantined ({why})")
            continue
        importers = ", ".join(rep["aux_importers"].get(mod, ["?"])[:3])
        result.add("aux-only-module", mod, 0,
                   f"kept alive only by {importers} — quarantine it in "
                   "DEADCODE_QUARANTINE with a reason, or delete module "
                   "and scaffold together")
    for mod in rep["stale_quarantine"]:
        why = ("runtime-reachable again" if mod in rep["runtime"]
               else "no longer exists")
        result.add("stale-quarantine", mod, 0,
                   f"DEADCODE_QUARANTINE entry is stale: module is {why}")
    return result
