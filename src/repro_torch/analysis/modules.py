"""The parsed modules of a package tree, for the rules' cross-module views.

The port's host loops call across modules (``pipeline._advance`` reads
the schedule that ``recolor.recolor_schedule`` returns, and passes its
``comm`` to ``recolor.recolor_steps``), so the uniformity analysis and
the key rule summarise functions of other modules of the same package.
A :class:`ModuleIndex` finds a module's file from its dotted name under
the source root of the file being linted (the first directory upwards
without an ``__init__.py``), parses it once and keeps its import table.
A file outside any package (a lint fixture at a made-up path) resolves
nothing: its calls to other modules are opaque.
"""
from __future__ import annotations

import ast
from pathlib import Path


class ModuleInfo:
    """One parsed module: its functions, classes, module-level names and
    import table (``name -> ("module", dotted)`` or ``("symbol", dotted,
    name)``)."""

    def __init__(self, tree: ast.Module, name: str, index: "ModuleIndex"):
        self.tree = tree
        self.name = name              # dotted, "" when unknown
        self.index = index
        self.funcs: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self.module_names: set[str] = set()
        self.imports: dict[str, tuple] = {}
        package = name.rsplit(".", 1)[0] if "." in name else ""
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self.module_names.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    local = (a.asname or a.name).split(".")[0]
                    self.module_names.add(local)
                    self.imports[local] = ("module", a.name if a.asname
                                           else local)
            elif isinstance(node, ast.ImportFrom):
                base = _absolute(node, package)
                for a in node.names:
                    local = a.asname or a.name
                    self.module_names.add(local)
                    if base is not None:
                        self.imports[local] = ("symbol", base, a.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            self.module_names.add(n.id)

    def resolve(self, local: str, depth: int = 0):
        """What the module-level name ``local`` is: ``("func", info,
        node)``, ``("class", info, node)``, ``("module", info)`` or None."""
        if local in self.funcs:
            return ("func", self, self.funcs[local])
        if local in self.classes:
            return ("class", self, self.classes[local])
        imp = self.imports.get(local)
        if imp is None or depth > 4:
            return None
        if imp[0] == "module":
            info = self.index.module(imp[1])
            return None if info is None else ("module", info)
        _, base, name = imp
        sub = self.index.module(f"{base}.{name}")
        if sub is not None:
            return ("module", sub)
        info = self.index.module(base)
        return None if info is None else info.resolve(name, depth + 1)

    def resolve_attr(self, expr: ast.expr):
        """``mod.fn`` / ``pkg.mod.fn`` / a bare name, resolved through the
        import table (None when not a module-level function or class of
        the package)."""
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        got = self.resolve(expr.id)
        for attr in reversed(parts):
            if got is None or got[0] != "module":
                return None
            got = got[1].resolve(attr)
        return got


def _absolute(node: ast.ImportFrom, package: str) -> str | None:
    if not node.level:
        return node.module
    if not package and node.level:
        return None
    parts = package.split(".")
    if node.level - 1 > len(parts):
        return None
    base = parts[:len(parts) - (node.level - 1)]
    if node.module:
        base.append(node.module)
    return ".".join(base)


class ModuleIndex:
    """Modules of the package trees under the source roots seen so far,
    parsed on demand and cached by dotted name."""

    def __init__(self):
        self._roots: list[Path] = []
        self._by_name: dict[str, ModuleInfo | None] = {}

    def module_of(self, tree: ast.Module, path: Path | None) -> ModuleInfo:
        """The :class:`ModuleInfo` of a parsed file (registering its source
        root), or an anonymous one when the file is in no package."""
        name = ""
        if path is not None and path.exists():
            root, name = _root_and_name(path.resolve())
            if root is not None and root not in self._roots:
                self._roots.append(root)
        info = ModuleInfo(tree, name, self)
        if name:
            self._by_name.setdefault(name, info)
            return self._by_name[name]
        return info

    def module(self, dotted: str) -> ModuleInfo | None:
        if dotted in self._by_name:
            return self._by_name[dotted]
        info = None
        for root in self._roots:
            base = root.joinpath(*dotted.split("."))
            for p in (base.with_suffix(".py"), base / "__init__.py"):
                if p.is_file():
                    try:
                        tree = ast.parse(p.read_text(), filename=str(p))
                    except SyntaxError:
                        continue
                    info = ModuleInfo(tree, dotted, self)
                    break
            if info is not None:
                break
        self._by_name[dotted] = info
        return info


def _root_and_name(path: Path) -> tuple[Path | None, str]:
    parts = [] if path.name == "__init__.py" else [path.stem]
    d = path.parent
    if not (d / "__init__.py").exists():
        return None, ""
    while (d / "__init__.py").exists():
        parts.append(d.name)
        d = d.parent
    return d, ".".join(reversed(parts))
