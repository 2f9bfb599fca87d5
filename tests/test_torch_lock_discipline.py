"""No torch work under a lock in the port's ``ann/``, ``serving/`` and
``checkpoint/``.

A ``.cpu()``, ``.item()``, ``.numpy()`` or ``.to(`` under a lock waits for
the card (a host copy synchronises the stream), as does
``torch.cuda.synchronize`` and any search; every writer queued behind that
lock would wait with it. The static lint's B001 sees only JAX dispatch, so
this scan is the port's own check: every ``with <lock>:`` body (a lock,
mutex or condition by name, the serving engine's ``_work`` and ``_baton``
conditions included), and every function of these files it calls
(resolved by name, transitively), must make none of those calls.
"""
import ast
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted((PORT / "ann").glob("*.py")) + sorted((PORT / "serving").glob("*.py")) \
    + sorted((PORT / "checkpoint").glob("*.py"))

#: method names that move a tensor to the host or wait for the device
TORCH_SYNC = {"cpu", "item", "numpy", "to"}
#: names that run a search (the device query path)
SEARCH = {"searcher", "_default_searcher", "_base_searcher", "run_padded", "run_padded_device",
          "search", "search_with_stats", "query_with_stats"}


def _chain(node) -> list[str]:
    out = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return out[::-1]


def _is_lock(expr) -> bool:
    chain = _chain(expr)
    if not chain:
        return False
    last = chain[-1].lower()
    return "lock" in last or last in ("_mu", "_cv", "_cond", "_work", "_baton")


def _functions(trees) -> dict[str, list[ast.AST]]:
    """Function name -> defs (module functions and methods; a class name
    maps to its ``__init__``), over every scanned file."""
    out: dict[str, list[ast.AST]] = {}
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) and item.name == "__init__":
                        out.setdefault(node.name, []).append(item)
    return out


def lock_violations(paths, root: Path = ROOT) -> tuple[list[str], int]:
    """(findings, lock bodies scanned) over ``paths`` (shown relative to
    ``root``)."""
    trees = {p: ast.parse(p.read_text()) for p in paths}
    funcs = _functions(trees.values())
    findings, bodies = [], 0

    def scan(nodes, where, seen):
        for node in nodes:
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                chain = _chain(call.func)
                if not chain:
                    continue
                name = chain[-1]
                bad = (len(chain) > 1 and name in TORCH_SYNC) or name in SEARCH \
                    or chain[-3:] == ["torch", "cuda", "synchronize"]
                if bad:
                    findings.append(f"{where}: {'.'.join(chain)}() at line {call.lineno}")
                for fn in funcs.get(name, ()):
                    if id(fn) not in seen:
                        seen.add(id(fn))
                        scan(fn.body, f"{where} -> {fn.name}", seen)

    for path, tree in trees.items():
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_lock(item.context_expr) for item in node.items):
                bodies += 1
                scan(node.body, f"{path.relative_to(root)}:{node.lineno}", set())
    return findings, bodies


def test_no_torch_sync_or_search_under_a_lock():
    assert {"mutable.py", "scheduler.py", "ann_engine.py", "checkpoint.py"} \
        <= {p.name for p in FILES}
    findings, bodies = lock_violations(FILES)
    assert bodies >= 45, "the scan no longer finds the port's lock bodies"
    assert findings == [], "\n".join(findings)


def test_the_scan_catches_each_kind(tmp_path):
    src = textwrap.dedent("""
        import threading, torch

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            def copy(self, t):
                with self._lock:
                    return t.cpu()

            def sync(self):
                with self._lock:
                    torch.cuda.synchronize()

            def query(self, index, q):
                with self._lock:
                    return self.helper(index, q)

            def helper(self, index, q):
                return index.searcher().search(q)

            def fine(self, t):
                x = t.item()
                with self._lock:
                    return x + 1
    """)
    path = tmp_path / "snippet.py"
    path.write_text(src)
    findings, bodies = lock_violations([path], root=tmp_path)
    assert bodies == 4
    joined = "\n".join(findings)
    assert "t.cpu()" in joined and "torch.cuda.synchronize()" in joined
    assert "-> helper" in joined and "searcher" in joined
    assert "item" not in joined

