"""Deterministic local text corpus for accuracy benchmarks.

This environment has no network egress, so WikiText-2 cannot be fetched.
Instead the accuracy benchmark builds a reproducible English/code corpus
from documentation files already on disk (package READMEs, licenses, rst
docs) — enough signal to pretrain a small byte-level LM whose quantized
perplexity deltas are then measured exactly as they would be on WikiText-2
(the harness in quanta_tpu_torch.eval is corpus-agnostic).

The port's own copy of ``quanta_tpu/benchmarks/corpus.py``: the same files
in the same order, so both packages build the same corpus on one machine.
"""

from __future__ import annotations

import hashlib
import os
from typing import List

_EXTS = (".md", ".rst", ".txt")


def _candidate_files(roots: List[str]) -> List[str]:
    files = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            if "__pycache__" in dirpath or "/tests/" in dirpath:
                continue
            for f in sorted(filenames):
                if f.endswith(_EXTS) or f.startswith(("LICENSE", "README")):
                    files.append(os.path.join(dirpath, f))
    return files


def build_corpus(max_bytes: int = 4 << 20, roots: List[str] | None = None) -> str:
    """Concatenate local doc files (deterministic order) up to max_bytes."""
    if roots is None:
        import numpy

        sp = os.path.dirname(os.path.dirname(numpy.__file__))
        roots = [sp]
    files = _candidate_files(roots)
    # deterministic shuffle by content-path hash so no single package
    # dominates the head of the stream
    files.sort(key=lambda p: hashlib.md5(p.encode()).hexdigest())
    chunks, total = [], 0
    for path in files:
        try:
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                text = f.read()
        except OSError:
            continue
        if len(text) < 256:
            continue
        chunks.append(text)
        total += len(text)
        if total >= max_bytes:
            break
    corpus = "\n\n".join(chunks)[:max_bytes]
    if len(corpus) < max_bytes // 4:
        raise RuntimeError(f"could only assemble {len(corpus)} bytes of corpus")
    return corpus


def train_eval_split(corpus: str, eval_frac: float = 0.05):
    cut = int(len(corpus) * (1 - eval_frac))
    return corpus[:cut], corpus[cut:]
