"""The port's isolation from the JAX package, as a source scan.

The port keeps its own copy of what it needs and reaches no file of the
JAX package. ``jax_package_references`` finds any path or import in the
port's sources that does; ``tests/test_torch_import.py`` and
``chip_smoke.py`` both fail on one. Standard library only.
"""

import io
import os
import re
import tokenize

_PATTERN = re.compile(r"\bdemethify_tpu\b")


def jax_package_references(root):
    """(file, line) of every path or import in the port's sources under
    ``root`` (``demethify_tpu_torch/**/*.py``, ``*.cu``, ``*.cuh``) that
    reaches the JAX package (``demethify_tpu/...`` or ``demethify_tpu.``),
    outside docstrings and comments. Counterpart notes in docstrings and
    comments are fine."""
    found = []
    pkg = os.path.join(root, "demethify_tpu_torch")
    for base, _, files in os.walk(pkg):
        for name in sorted(files):
            path = os.path.join(base, name)
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
            if name.endswith(".py"):
                prev = tokenize.NEWLINE
                lines = io.StringIO(text).readline
                for tok in tokenize.generate_tokens(lines):
                    docstring = (tok.type == tokenize.STRING and prev in (
                        tokenize.NEWLINE, tokenize.NL, tokenize.INDENT))
                    if (tok.type not in (tokenize.COMMENT, tokenize.NL,
                                         tokenize.NEWLINE)
                            and not docstring and _PATTERN.search(tok.string)):
                        found.append((rel, tok.start[0]))
                    if tok.type not in (tokenize.COMMENT, tokenize.NL):
                        prev = tok.type
            elif name.endswith((".cu", ".cuh")):
                code = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
                for i, line in enumerate(code.splitlines(), 1):
                    if _PATTERN.search(line.split("//")[0]):
                        found.append((rel, i))
    return found
