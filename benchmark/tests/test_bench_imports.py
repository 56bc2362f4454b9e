"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: every module ``benchmark/``
imports is walked by its AST, through the program's own modules, and each
top-level name is compared whole (the port's ``f5tts_tpu_torch`` begins with
the JAX package's ``f5tts_tpu``)."""

import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

FOREIGN = {"jax", "jaxlib", "f5tts_tpu"}


def _module_file(name: str) -> str | None:
    base = os.path.join(ROOT, *name.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(path):
            return path
    return None


def _imports(path: str, package: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([node.module] if node.module else []))
            else:
                base = node.module
            out.add(base)
            out |= {f"{base}.{a.name}" for a in node.names}
    return out


def _walk(start: list[str]) -> dict[str, set[str]]:
    """Module -> its imports, for ``start`` and every repo module reached."""
    seen: dict[str, set[str]] = {}
    todo = list(start)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        path = _module_file(name)
        if path is None:
            continue
        pkg = name if path.endswith("__init__.py") else name.rpartition(".")[0]
        seen[name] = _imports(path, pkg)
        todo += [m for m in seen[name] if m.split(".")[0] in ("benchmark", "f5tts_tpu_torch", "f5tts_tpu")]
    return seen


def _bench_modules(sub: str = "") -> list[str]:
    top = os.path.join(ROOT, "benchmark", sub)
    out = []
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3].replace(os.sep, ".")
                out.append(rel.removesuffix(".__init__"))
    return out


def test_nothing_the_benchmark_imports_is_jax():
    seen = _walk(_bench_modules())
    assert any(m.startswith("f5tts_tpu_torch.") for m in seen), "the walk must reach the program"
    bad = {m: sorted(i for i in imps if i.split(".")[0] in FOREIGN) for m, imps in seen.items()}
    assert not {m: b for m, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    seen = _walk(_bench_modules("reference"))
    bad = {m: sorted(i for i in imps if i.split(".")[0] in FOREIGN | {"f5tts_tpu_torch"}) for m, imps in seen.items()}
    assert not {m: b for m, b in bad.items() if b}
    assert all(m.startswith("benchmark.reference") for m in seen)


def test_names_are_compared_whole():
    assert "f5tts_tpu_torch".split(".")[0] not in FOREIGN
    assert "f5tts_tpu.models".split(".")[0] in FOREIGN
