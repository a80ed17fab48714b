"""No module that gsbench runs imports JAX or the JAX package, judged by the
whole top-level name of each import (gaustudio_torch begins with the JAX
package's name and is allowed), and the plain reference and the counts
import nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "gaustudio_tpu"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(*patterns) -> list:
    return sorted(p for pat in patterns for p in glob.glob(os.path.join(ROOT, pat), recursive=True))


def test_top_level_name_is_compared_whole():
    assert "gaustudio_torch".split(".")[0] not in FORBIDDEN
    assert "gaustudio_tpu.ops".split(".")[0] in FORBIDDEN


def test_no_forbidden_import_in_what_gsbench_runs():
    files = sources("gsbench/**/*.py", "gaustudio_torch/**/*.py")
    files = [f for f in files if os.sep + "tests" + os.sep not in f]
    assert len(files) > 50
    bad = {f: top_level_imports(f) & FORBIDDEN for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_reference_and_counts_import_nothing_of_the_program():
    """The yardstick (the reference and the counts) calls nothing of the
    program, so a program change cannot move it."""
    for f in sources("gsbench/reference/*.py", "gsbench/counts/*.py"):
        names = top_level_imports(f)
        assert "gaustudio_torch" not in names and not names & FORBIDDEN, (f, names)
        assert names <= {"__future__", "math", "typing", "numpy", "torch", "gsbench"}, (f, names)


def test_a_run_loads_no_forbidden_module():
    """Every driver, reader and count module imported in a fresh process
    with the port's modules they use: nothing forbidden in sys.modules."""
    code = (
        "import sys, glob, os; sys.path.insert(0, %r)\n"
        "from gsbench import run as h\n"
        "for p in glob.glob(os.path.join(%r, 'gsbench', '*', '*.py')):\n"
        "    if '/tests/' not in p: h._load(p, 'm_' + os.path.basename(p).replace('.', '_'))\n"
        "import gaustudio_torch.pipelines.train\n"
        "import gaustudio_torch.pipelines.mesh_extraction, gaustudio_torch.scripts.render\n"
        "import gaustudio_torch.renderers.vanilla, gaustudio_torch.renderers.surfel\n"
        "print(h.forbidden_modules())\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
