"""Frequent pattern mining (the JAX package's ``models/fpm.py``) —
FPGrowth and PrefixSpan (``pyspark.ml.fpm``).

Han's FP-growth over an FP-tree, the algorithm Spark parallelizes as PFP
(per-suffix conditional trees on executors).  Pattern mining is symbolic,
branchy and dictionary-heavy, so it runs on the host in both packages and
takes no ``device=``.  Surface parity: ``freq_itemsets``,
single-consequent ``association_rules`` with confidence/lift/support
(Spark's columns), and ``transform`` (union of rule consequents whose
antecedents are contained in the row, minus items already present).
"""

from __future__ import annotations

from collections import defaultdict
from functools import cached_property
from dataclasses import dataclass

import numpy as np

from ..io.model_io import register_model


class _Node:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: dict = {}


def _build_tree(rows, min_count, order=None):
    """→ (root, header links item → [nodes]), items below min_count
    dropped, rows sorted by global frequency order."""
    if order is None:
        counts = defaultdict(int)
        for row, mult in rows_with_mult(rows):
            for it in set(row):
                counts[it] += mult
        order = {
            it: i
            for i, (it, c) in enumerate(
                sorted(counts.items(), key=lambda kv: (-kv[1], str(kv[0])))
            )
            if c >= min_count
        }
    root = _Node(None, None)
    header = defaultdict(list)
    for row, mult in rows_with_mult(rows):
        items = sorted(
            {it for it in row if it in order}, key=lambda it: order[it]
        )
        node = root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _Node(it, node)
                node.children[it] = child
                header[it].append(child)
            child.count += mult
            node = child
    return root, header, order


def rows_with_mult(rows):
    for r in rows:
        if isinstance(r, tuple) and len(r) == 2 and isinstance(r[1], int):
            yield r[0], r[1]
        else:
            yield r, 1


def _mine(header, order, min_count, suffix, out):
    """Classic conditional-tree recursion (items in REVERSE frequency
    order so every suffix's conditional base is complete)."""
    for it in sorted(header, key=lambda i: -order[i]):
        nodes = header[it]
        support = sum(n.count for n in nodes)
        if support < min_count:
            continue
        itemset = (it,) + suffix
        out[frozenset(itemset)] = support
        # conditional pattern base: prefix paths with this item's counts
        cond_rows = []
        for n in nodes:
            path = []
            p = n.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                cond_rows.append((path, n.count))
        if cond_rows:
            _, sub_header, sub_order = _build_tree(cond_rows, min_count)
            if sub_header:
                _mine(sub_header, sub_order, min_count, itemset, out)


@register_model("FPGrowthModel")
@dataclass
class FPGrowthModel:
    freq_itemsets: list               # [(items tuple, count), ...]
    n_rows: int
    min_confidence: float = 0.8

    @cached_property
    def association_rules(self):
        """[(antecedent, consequent item, confidence, lift, support), ...]
        — Spark's single-consequent rules, filtered by minConfidence."""
        support = {frozenset(items): c for items, c in self.freq_itemsets}
        rules = []
        for items, c in self.freq_itemsets:
            if len(items) < 2:
                continue
            fs = frozenset(items)
            for cons in items:
                ant = fs - {cons}
                ant_c = support.get(ant)
                if not ant_c:
                    continue
                conf = c / ant_c
                if conf < self.min_confidence:
                    continue
                cons_c = support.get(frozenset((cons,)), 0)
                lift = (
                    conf / (cons_c / self.n_rows) if cons_c else float("nan")
                )
                rules.append(
                    (tuple(sorted(ant, key=str)), cons, conf, lift, c / self.n_rows)
                )
        rules.sort(key=lambda r: (-r[2], str(r[0])))
        return rules

    def transform(self, itemsets) -> list:
        """Per row: sorted union of rule consequents whose antecedent is
        contained in the row and whose consequent is absent (Spark's
        ``prediction`` column)."""
        rules = self.association_rules
        out = []
        for row in itemsets:
            have = set(row)
            pred = {
                cons
                for ant, cons, _, _, _ in rules
                if set(ant) <= have and cons not in have
            }
            out.append(sorted(pred, key=str))
        return out

    def _artifacts(self):
        return (
            "FPGrowthModel",
            {
                "n_rows": int(self.n_rows),
                "min_confidence": float(self.min_confidence),
                # items persist VERBATIM (ints/strings are both JSON-safe;
                # stringifying would break set-containment after reload)
                "freq_itemsets": [
                    [list(items), int(c)] for items, c in self.freq_itemsets
                ],
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            freq_itemsets=[
                (tuple(items), int(c)) for items, c in params["freq_itemsets"]
            ],
            n_rows=int(params["n_rows"]),
            min_confidence=float(params.get("min_confidence", 0.8)),
        )


@dataclass(frozen=True)
class FPGrowth:
    """Spark defaults: minSupport 0.3, minConfidence 0.8."""

    min_support: float = 0.3
    min_confidence: float = 0.8

    def fit(self, itemsets) -> FPGrowthModel:
        """``itemsets``: iterable of per-row item collections (duplicates
        within a row collapse, Spark's set semantics)."""
        rows = [list(r) for r in itemsets]
        if not rows:
            raise ValueError("FPGrowth fit on an empty transaction set")
        if not 0.0 < self.min_support <= 1.0:
            raise ValueError(
                f"min_support must be in (0, 1], got {self.min_support}"
            )
        min_count = max(int(np.ceil(self.min_support * len(rows))), 1)
        _, header, order = _build_tree(rows, min_count)
        mined: dict = {}
        _mine(header, order, min_count, (), mined)
        freq = [
            (tuple(sorted(items, key=str)), c) for items, c in mined.items()
        ]
        freq.sort(key=lambda kv: (-kv[1], kv[0]))
        return FPGrowthModel(
            freq_itemsets=freq,
            n_rows=len(rows),
            min_confidence=self.min_confidence,
        )


# ------------------------------------------------------------- PrefixSpan
def _seq_contains(seq: list, pattern: list) -> bool:
    """Greedy earliest-embedding subsequence test: pattern elements map to
    strictly increasing sequence elements with itemset containment (the
    PrefixSpan pattern-occurrence rule; greedy matching is complete for
    existence)."""
    i = 0
    for elem in seq:
        if i < len(pattern) and pattern[i] <= elem:
            i += 1
    return i == len(pattern)


@dataclass(frozen=True)
class PrefixSpan:
    """Sequential pattern mining (``pyspark.ml.fpm.PrefixSpan``).

    Spark defaults: minSupport 0.1, maxPatternLength 10.  Sequences are
    lists of itemsets; a pattern occurs in a sequence when its elements
    map to strictly increasing sequence positions with itemset
    containment.  Host-side DFS with support-based pruning (symbolic
    search — the same placement argument as FP-growth); candidate
    extensions are drawn only from sequences still supporting the
    current prefix, and both s-extensions (new element) and i-extensions
    (grow the last element) are explored, so the enumeration is exactly
    the PrefixSpan pattern space."""

    min_support: float = 0.1
    max_pattern_length: int = 10

    def find_frequent_sequential_patterns(self, sequences) -> list:
        """→ [(pattern as tuple of sorted item tuples, count), ...] sorted
        by descending count (Spark's freq column)."""
        all_seqs = [
            [frozenset(elem) for elem in seq if len(elem) > 0]
            for seq in sequences
        ]
        n_total = len(all_seqs)          # Spark's support denominator
        db = [s for s in all_seqs if s]  # empty sequences support nothing
        if n_total == 0:
            raise ValueError("PrefixSpan on an empty sequence database")
        if not 0.0 < self.min_support <= 1.0:
            raise ValueError(
                f"min_support must be in (0, 1], got {self.min_support}"
            )
        if self.max_pattern_length < 1:
            raise ValueError(
                f"max_pattern_length must be >= 1, got {self.max_pattern_length}"
            )
        # minCount over ALL input sequences (Spark counts empties in the
        # denominator even though they can never support a pattern)
        min_count = max(int(np.ceil(self.min_support * n_total)), 1)
        if not db:
            return []
        out: list = []

        def extensions(support_ids, pattern):
            """Candidate (kind, item) extensions from supporting seqs."""
            s_items: set = set()
            i_items: set = set()
            last = pattern[-1] if pattern else None
            for sid in support_ids:
                for elem in db[sid]:
                    s_items |= elem
                    if last is not None:
                        # i-extension candidates: items co-occurring with
                        # the full last element, ordered after its max
                        if last <= elem:
                            i_items |= {
                                it for it in elem
                                if it not in last
                                and str(it) > max(map(str, last))
                            }
            return s_items, i_items

        def dfs(pattern, support_ids):
            length = sum(len(e) for e in pattern)
            if length >= self.max_pattern_length:
                return
            s_items, i_items = extensions(support_ids, pattern)
            for kind, items in (("s", s_items), ("i", i_items)):
                for it in sorted(items, key=str):
                    if kind == "s":
                        cand = pattern + [frozenset((it,))]
                    else:
                        cand = pattern[:-1] + [pattern[-1] | {it}]
                    sup = [
                        sid for sid in support_ids
                        if _seq_contains(db[sid], cand)
                    ]
                    if len(sup) >= min_count:
                        out.append(
                            (
                                tuple(
                                    tuple(sorted(e, key=str)) for e in cand
                                ),
                                len(sup),
                            )
                        )
                        dfs(cand, sup)

        dfs([], list(range(len(db))))
        # str-keyed ordering like every other sort here (mixed-type items
        # would TypeError under raw tuple comparison)
        out.sort(key=lambda kv: (-kv[1], str(kv[0])))
        return out


__all__ = ["FPGrowth", "FPGrowthModel", "PrefixSpan"]
