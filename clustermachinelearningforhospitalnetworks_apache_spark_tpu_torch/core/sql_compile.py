"""Compiled SQL executor: logical plans → torch ops over columns on the card.

Layer 3 of the split engine (parse → logical plan → execution, the Flare
move).  A fully-supported :class:`~.sql_plan.LogicalPlan` runs here as
torch ops over device-held column tensors instead of the numpy
interpreter's host column sweeps — the JAX package's jitted columnar
kernels (``core/sql_compile.py``), written as eager torch on ``device``.

Execution contract
------------------
* Columns live on the device at their true length (``Table.device_column``
  cache: float64 / int64 / timestamp-as-int64-ns, so comparisons and
  aggregates match the float64 numpy interpreter, not float32 rounding).
  Eager torch has no executable to reuse, so there are no row buckets:
  nothing is padded and every op sees exactly the table's rows.
* Row-level plans produce a :class:`DeviceView`: the filter mask plus
  computed columns, still on the device.  ``to_table()`` materializes a
  host Table with ONE device→host copy (mask + computed columns packed
  into one buffer); pass-through columns — strings included — come from
  the host source array, so the device never sees a string.
* Aggregate plans run the sort→segment machinery on the device and fetch
  only the (tiny) per-group results, again in one copy.

Null semantics are the interpreter's, pinned by the fuzz harness (the JAX
package's ``core/sql_fuzz.py``): NaN/NaT are null, nulls never match
predicates (SQL 3VL), aggregates skip nulls, all-null groups yield null.
Float64 sums on CUDA (``index_add_``) add in atomic order, so they agree
with the interpreter to the harness's rtol 1e-9, not bit for bit.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import reduce
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .sql_parse import _Query, parse
from .table import Table

#: int64 view of NaT — the device null sentinel for timestamp columns
NAT_SENTINEL = int(np.datetime64("NaT", "ns").view(np.int64))

_F64, _I64 = torch.float64, torch.int64
_INF, _NAN = float("inf"), float("nan")


def string_group_codes(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Object (string) column → ``(int64 codes, sorted distinct values)``.

    A code is the value's rank among the SORTED distinct non-null
    values; every null (``None``, or the float NaN a LEFT JOIN writes
    into object cells) folds to the ONE code ``len(uniq)``, sorting
    last — the slot np.unique gives float NaN.  Rank order is isomorphic
    to the values' own lexicographic order, so a row's code never
    depends on which *other* rows are present: the device kernel can
    encode before filtering and its code-ascending group order still
    matches the interpreter's post-filter order.  This is the ONE
    factorization shared by the interpreter's grouping identity
    (``sql._group_codes``) and the compiled executor.
    """
    null = np.fromiter(
        (v is None or (isinstance(v, float) and v != v) for v in col),
        bool,
        count=len(col),
    )
    uniq, inv = np.unique(col[~null], return_inverse=True)
    codes = np.full(len(col), len(uniq), dtype=np.int64)
    codes[~null] = inv
    return codes, uniq


# ------------------------------------------------------------- lowering
def _null_mask(arr, ch):
    if ch == "f":
        return torch.isnan(arr)
    if ch == "t":
        return arr == NAT_SENTINEL
    return torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)


def _against(v, lit):
    """``v`` ready to compare with the literal ``lit``: an integer column
    against a float literal compares in float64, numpy's promotion (torch
    would promote to float32)."""
    if isinstance(lit, float) and not v.is_floating_point():
        return v.to(_F64)
    return v


def _cond3(env, types, cond):
    """Lowered predicate tree → (true_mask, unknown_mask), the device
    port of the interpreter's ``_eval_cond3`` 3VL."""
    kind = cond[0]
    if kind == "and":
        t1, n1 = _cond3(env, types, cond[1])
        t2, n2 = _cond3(env, types, cond[2])
        f1, f2 = ~t1 & ~n1, ~t2 & ~n2
        return t1 & t2, ~(f1 | f2) & (n1 | n2)
    if kind == "or":
        t1, n1 = _cond3(env, types, cond[1])
        t2, n2 = _cond3(env, types, cond[2])
        t = t1 | t2
        return t, ~t & (n1 | n2)
    if kind == "not":
        t, n = _cond3(env, types, cond[1])
        return ~t & ~n, n
    if kind == "isnull":
        v = env[cond[1]]
        return _null_mask(v, types[cond[1]]), torch.zeros_like(v, dtype=torch.bool)
    if kind in ("in", "notin"):
        _, name, vals = cond
        v = env[name]
        null = _null_mask(v, types[name])
        if vals:
            hit = reduce(lambda a, b: a | b, [_against(v, x) == x for x in vals])
        else:
            hit = torch.zeros_like(v, dtype=torch.bool)
        t = (~hit if kind == "notin" else hit) & ~null
        return t, null
    if kind == "between":
        _, name, lo, hi = cond
        v = env[name]
        null = _null_mask(v, types[name])
        return (_against(v, lo) >= lo) & (_against(v, hi) <= hi) & ~null, null
    _, name, op, lit = cond
    v = env[name]
    null = _null_mask(v, types[name])
    w = _against(v, lit)
    t = {
        "=": lambda: w == lit,
        "!=": lambda: w != lit,
        "<": lambda: w < lit,
        "<=": lambda: w <= lit,
        ">": lambda: w > lit,
        ">=": lambda: w >= lit,
    }[op]() & ~null
    return t, null


def _expr_char(e, types) -> str:
    """Result dtype char of a lowered expression (mirrors the planner's
    inference = numpy's promotion)."""
    k = e[0]
    if k == "col":
        return types[e[1]]
    if k == "lit":
        return "i" if isinstance(e[1], int) else "f"
    if k == "neg":
        return _expr_char(e[1], types)
    if k == "bin":
        if e[1] == "/":
            return "f"
        return (
            "f"
            if "f" in (_expr_char(e[2], types), _expr_char(e[3], types))
            else "i"
        )
    if k == "case":
        if e[2] is None:
            return "f"
        chars = [_expr_char(v, types) for _, v in e[1]]
        chars.append(_expr_char(e[2], types))
        return "f" if "f" in chars else "i"
    if k == "fn":
        if e[1] == "abs":
            return _expr_char(e[2][0], types)
        return (
            "f"
            if any(_expr_char(a, types) == "f" for a in e[2])
            else "i"
        )
    raise AssertionError(f"unlowerable expr {k}")


def _eval_expr(env, types, e, dev):
    """Lowered numeric expression → device tensor (int64 or float64; a
    literal is a 0-d tensor, so torch promotes as numpy does), matching
    the interpreter's null propagation (NaN flows through arithmetic;
    ``/ 0`` yields NaN)."""
    k = e[0]
    if k == "col":
        return env[e[1]]
    if k == "lit":
        return torch.tensor(e[1], dtype=_I64 if isinstance(e[1], int) else _F64, device=dev)
    if k == "neg":
        return -_eval_expr(env, types, e[1], dev)
    if k == "bin":
        _, op, a, b = e
        lv = _eval_expr(env, types, a, dev)
        rv = _eval_expr(env, types, b, dev)
        if op == "+":
            return lv + rv
        if op == "-":
            return lv - rv
        if op == "*":
            return lv * rv
        den = rv.to(_F64)
        den = den.masked_fill(den == 0, _NAN)
        return lv.to(_F64) / den
    if k == "case":
        branches, default = e[1], e[2]
        conds = [_cond3(env, types, c)[0] for c, _ in branches]
        dt = _F64 if _expr_char(e, types) == "f" else _I64
        if default is None:
            out = torch.tensor(_NAN, dtype=_F64, device=dev)
        else:
            out = _eval_expr(env, types, default, dev).to(dt)
        # the first true branch wins: fold from the last branch back
        for c, (_, v) in zip(reversed(conds), reversed(branches)):
            out = torch.where(c, _eval_expr(env, types, v, dev).to(dt), out)
        return out
    if k == "fn":
        name, args = e[1], e[2]
        if name == "abs":
            return torch.abs(_eval_expr(env, types, args[0], dev))
        # coalesce: int-typed means every arg is a null-free int column
        # or literal — first argument wins (the interpreter breaks out of
        # its fold on the first no-missing pass); float folds the misses
        vals = [_eval_expr(env, types, a, dev) for a in args]
        if _expr_char(e, types) == "i":
            return vals[0]
        out = vals[0].to(_F64)
        for v in vals[1:]:
            out = torch.where(torch.isnan(out), v.to(_F64), out)
        return out
    raise AssertionError(f"unlowerable expr {k}")


def kernel_columns(sig: tuple) -> tuple:
    """The ONE definition of which source columns a plan's device work
    consumes, and in what order — shared by the runners (operand list)
    and the evaluators (``env = dict(zip(...))``)."""
    kind, filter_tree, outputs, group_keys, _ = sig
    needed: set = set(_lowered_cols(filter_tree)) if filter_tree else set()
    if kind == "aggregate":
        needed.update(src for src, _ in group_keys)
        needed.update(o[2] for o in outputs if o[0] == "agg")
    else:
        for o in outputs:
            if o[0] == "expr":
                needed |= _lowered_cols(o[1])
            elif o[0] == "win":
                if o[2] is not None:
                    needed.add(o[2])
                needed.update(o[3])
    return tuple(sorted(needed))


def _lowered_cols(tree) -> set:
    """Source columns referenced by a lowered cond/expr tuple tree."""
    out: set = set()

    def walk(node):
        if not isinstance(node, tuple):
            return
        if node and node[0] in ("col",):
            out.add(node[1])
            return
        if node and node[0] in (
            "cmp", "between", "isnull", "in", "notin",
        ):
            out.add(node[1])
        for x in node:
            if isinstance(x, tuple):
                walk(x)
    walk(tree)
    return out


# --------------------------------------------------- segment machinery
def _nan_zero(arr):
    # NOT nan_to_num: that would also fold ±inf into finite values,
    # merging distinct groups; only the nulls need a placeholder
    return arr.masked_fill(torch.isnan(arr), 0.0)


def _neq_prev(x):
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), x[1:] != x[:-1]])


def _lexsort(comps):
    """``np.lexsort``: the LAST component is the primary key.  Stable
    sorts from the least significant component to the most."""
    perm = None
    for c in comps:
        key = c if perm is None else c[perm]
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _segments(keys, keep):
    """Group/partition machinery shared by GROUP BY and whole-partition
    windows: rows with ``keep`` False (filtered out) never form groups.

    → (seg, n_groups) where ``seg[i]`` is row i's 0-based group id in
    the interpreter's group order (keys ascending, float nulls last,
    NaT first via the raw int64 sentinel) and non-keep rows point at the
    dump slot ``n - 1`` (unused by real groups: when any row is dropped
    there are at most n - 1 groups).  ``n_groups`` is a 0-d tensor.
    """
    n = keep.shape[0]
    if n == 0:
        return keep.new_zeros(0, dtype=_I64), keep.new_zeros((), dtype=_I64)
    comps = []  # _lexsort: LAST component is the primary key
    for arr, ch in reversed(keys):  # minor keys first
        if ch == "f":
            comps.append(_nan_zero(arr))
            comps.append(torch.isnan(arr))  # nulls sort last (np.unique)
        else:
            comps.append(arr)  # int64; NaT sentinel = int64 min → first
    comps.append(~keep)  # primary: keep rows first
    perm = _lexsort(comps)
    keep_s = keep[perm]

    newgrp = torch.zeros(n, dtype=torch.bool, device=keep.device)
    newgrp[0] = True
    for arr, ch in keys:
        if ch == "f":
            newgrp |= _neq_prev(_nan_zero(arr)[perm]) | _neq_prev(torch.isnan(arr)[perm])
        else:
            newgrp |= _neq_prev(arr[perm])
    newgrp &= keep_s
    seg_sorted = torch.cumsum(newgrp, 0, dtype=_I64) - 1
    seg_sorted = seg_sorted.clamp(0, n - 1).masked_fill(~keep_s, n - 1)
    seg = torch.empty_like(seg_sorted).scatter_(0, perm, seg_sorted)
    return seg, newgrp.sum(dtype=_I64)


def _segment_agg(agg, v, ch, keep, seg, num):
    """One per-group aggregate over ORIGINAL-order values (segment ids
    carry the ordering) with interpreter null semantics; ``num`` slots."""
    null = _null_mask(v, ch)
    w = keep & ~null
    nn = torch.zeros(num, dtype=_I64, device=v.device).index_add_(0, seg, w.to(_I64))
    if agg == "count":
        return nn
    vf = v.to(_F64)
    empty = nn == 0
    if agg in ("sum", "avg"):
        s = torch.zeros(num, dtype=_F64, device=v.device).index_add_(
            0, seg, vf.masked_fill(~w, 0.0))
        if agg == "avg":
            s = s / nn.clamp(min=1)
        return s.masked_fill(empty, _NAN)
    fill, how = (_INF, "amin") if agg == "min" else (-_INF, "amax")
    m = torch.full((num,), fill, dtype=_F64, device=v.device).scatter_reduce_(
        0, seg, vf.masked_fill(~w, fill), how)
    return m.masked_fill(empty, _NAN)


def _whole_agg(agg, v, ch, keep):
    """A whole-table aggregate → 0-d tensor, interpreter null semantics."""
    w = keep & ~_null_mask(v, ch)
    nn = w.sum(dtype=_I64)
    if agg == "count":
        return nn
    vf = v.to(_F64)
    if agg in ("sum", "avg"):
        s = vf.masked_fill(~w, 0.0).sum()
        out = s if agg == "sum" else s / nn.clamp(min=1)
    else:
        fill = _INF if agg == "min" else -_INF
        x = vf.masked_fill(~w, fill)
        if x.numel() == 0:
            out = torch.tensor(fill, dtype=_F64, device=v.device)
        else:
            out = x.amin() if agg == "min" else x.amax()
    return out.masked_fill(nn == 0, _NAN)


# ------------------------------------------------------ plan evaluators
def _filter_mask(filter_tree, env, types, n, dev):
    if filter_tree is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    return _cond3(env, types, filter_tree)[0]


def _rowlevel(sig: tuple, n: int, cols: tuple, dev):
    """A row-level plan over ``n`` rows → (keep mask, computed columns)."""
    _, filter_tree, outputs, _, col_types = sig
    types = dict(col_types)
    env = dict(zip(kernel_columns(sig), cols))
    keep = _filter_mask(filter_tree, env, types, n, dev)
    # whole-partition windows share one segment pass per PARTITION BY
    seg_cache: dict = {}
    win_vals: dict = {}
    for _, agg, src, parts, alias, _ch in (o for o in outputs if o[0] == "win"):
        if parts not in seg_cache:
            seg_cache[parts] = _segments([(env[p], types[p]) for p in parts], keep)
        seg, _ng = seg_cache[parts]
        v = env[src] if src is not None else torch.ones(n, dtype=_F64, device=dev)
        vch = types[src] if src is not None else "f"
        win_vals[alias] = _segment_agg(agg, v, vch, keep, seg, n)[seg]
    comp = []
    for o in outputs:
        if o[0] == "expr":
            v = _eval_expr(env, types, o[1], dev)
            comp.append(torch.broadcast_to(v.to(_F64 if o[3] == "f" else _I64), (n,)))
        elif o[0] == "win":
            comp.append(win_vals[o[4]])
    return keep, tuple(comp)


def _aggregate(sig: tuple, n: int, cols: tuple, dev):
    """An aggregate plan over ``n`` rows → (n_groups 0-d, outputs), each
    grouped output with one slot per row (the first n_groups are real)."""
    _, filter_tree, outputs, group_keys, col_types = sig
    types = dict(col_types)
    env = dict(zip(kernel_columns(sig), cols))
    keep = _filter_mask(filter_tree, env, types, n, dev)
    if not group_keys:
        # whole-table aggregate: always exactly one output row
        outs = []
        for o in outputs:
            if o[0] == "count_star":
                outs.append(keep.sum(dtype=_I64))
            else:
                _, agg, src, _alias = o
                outs.append(_whole_agg(agg, env[src], types[src], keep))
        return torch.ones((), dtype=_I64, device=dev), tuple(outs)
    key_arrs = [(env[src], ch) for src, ch in group_keys]
    seg, n_groups = _segments(key_arrs, keep)
    outs = []
    for o in outputs:
        if o[0] == "key":
            arr, ch = key_arrs[o[1]]
            dt = _F64 if ch == "f" else _I64
            outs.append(torch.zeros(n, dtype=dt, device=dev).scatter_(0, seg, arr.to(dt)))
        elif o[0] == "count_star":
            outs.append(torch.zeros(n, dtype=_I64, device=dev).index_add_(0, seg, keep.to(_I64)))
        else:
            _, agg, src, _alias = o
            outs.append(_segment_agg(agg, env[src], types[src], keep, seg, n))
    return n_groups, tuple(outs)


_NP_DTYPE = {torch.bool: np.bool_, torch.int64: np.int64, torch.float64: np.float64}


def _fetch(tensors) -> list[np.ndarray]:
    """Tensors → host arrays with ONE device→host copy: their bytes are
    packed into one buffer on the device (each part padded to 8 bytes,
    so every host view is aligned) and copied once."""
    parts, spans = [], []
    for t in tensors:
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(flat)
        pad = -flat.numel() % 8
        if pad:
            parts.append(flat.new_zeros(pad))
        spans.append(flat.numel() + pad)
    host = torch.cat(parts).cpu().numpy() if parts else np.empty(0, np.uint8)
    out, off = [], 0
    for t, span in zip(tensors, spans):
        dt = np.dtype(_NP_DTYPE[t.dtype])
        out.append(host[off: off + t.numel() * dt.itemsize].view(dt).reshape(tuple(t.shape)))
        off += span
    return out


# --------------------------------------------------------- device views
@dataclass
class DeviceView:
    """A row-level compiled query's device-resident result: the filter
    mask plus computed columns.  Pass-through columns stay where they
    were — host numpy for strings, the device-column cache for numerics
    — until a consumer picks a side."""

    plan: Any
    table: Table
    device: torch.device
    n_rows: int
    mask: Any                        # bool[n_rows] on the device
    computed: dict = field(default_factory=dict)   # alias → device col

    @property
    def out_names(self) -> list[str]:
        return [o[2] if o[0] == "pass" else o[-2] for o in self.plan.outputs]

    def _out_spec(self, name: str):
        for o in self.plan.outputs:
            alias = o[2] if o[0] == "pass" else o[-2]
            if alias == name:
                return o
        raise KeyError(
            f"{name!r} is not an output column of the query; outputs: "
            f"{self.out_names}"
        )

    def device_array(self, name: str):
        """Output column as a device tensor (numeric outputs only) —
        pass-through columns come from the Table's device cache, computed
        ones from the evaluation."""
        o = self._out_spec(name)
        if o[0] == "pass":
            return self.table.device_column(o[1], self.device)
        return self.computed[name]

    def out_char(self, name: str) -> str:
        o = self._out_spec(name)
        if o[0] == "pass":
            return dict(self.plan.col_types)[o[1]]
        return o[-1]

    def to_table(self) -> Table:
        """Materialize on the host with ONE device→host copy (the
        compiled path's single host sync)."""
        host = _fetch([self.mask, *self.computed.values()])
        mask_h, comp_h = host[0], dict(zip(self.computed, host[1:]))
        idx = np.flatnonzero(mask_h)
        if self.plan.limit is not None:
            idx = idx[: self.plan.limit]
        cols: dict[str, np.ndarray] = {}
        for o in self.plan.outputs:
            if o[0] == "pass":
                cols[o[2]] = self.table.column(o[1])[idx]
            else:
                alias = o[-2]
                cols[alias] = comp_h[alias][idx]
        return Table.from_dict(cols)

    def assemble(self, feature_cols, label_col: str | None = None, na_drop: bool = True):
        """Fused feature assembly: the feature columns stacked into a
        float32 design matrix on the device, validity = the filter mask
        and, with ``na_drop``, no NaN in a float feature or a float label
        (an integer column has no null on the device).  Invalid rows stay
        in place, zeroed, with weight 0 — the training contract — so no
        row leaves the device.  Integer columns cast to float32 as the JAX
        package casts them (under ``enable_x64``).  → (x[n, d] f32,
        y[n] f32, w[n] f32) at the view's row count (the port keeps no
        row buckets)."""
        feature_cols = tuple(feature_cols)
        chars = tuple(self.out_char(c) for c in feature_cols)
        for c, ch in zip(feature_cols, chars):
            if ch not in ("i", "f"):
                raise TypeError(f"feature column {c!r} is not numeric")
        lab_ch = None
        if label_col is not None:
            lab_ch = self.out_char(label_col)
            if lab_ch not in ("i", "f"):
                raise TypeError(f"label column {label_col!r} is not numeric")
        feats = [self.device_array(c) for c in feature_cols]
        lab = self.device_array(label_col) if label_col is not None else None
        w = self.mask
        if na_drop:
            for a, ch in zip(feats, chars):
                if ch == "f":
                    w = w & ~torch.isnan(a)
            if lab is not None and lab_ch == "f":
                w = w & ~torch.isnan(lab)
        x = torch.stack([a.to(torch.float32) for a in feats], dim=1)
        x = torch.where(w[:, None], x, 0.0)
        if lab is None:
            y = torch.zeros(self.n_rows, dtype=torch.float32, device=self.device)
        else:
            y = torch.where(w, lab.to(torch.float32), 0.0)
        return x, y, w.to(torch.float32)


def compact_dataset(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """The valid rows (w > 0) of an assembled (x, y, w) triple gathered on
    the device, in source order, into exactly as many rows — one row of
    weight 0 when none is valid, as ``data.device_dataset`` pads an empty
    input.  The JAX package gathers into the power-of-two bucket that
    holds them; the port keeps no buckets.  Reading the valid count is
    the one host sync."""
    idx = torch.nonzero(w > 0).squeeze(1)
    if idx.numel() == 0:
        return one_empty_row(x)
    return x[idx], y[idx], w[idx]


def one_empty_row(x: torch.Tensor):
    """(x, y, w) of one zero row of weight 0 on ``x``'s device: an empty
    dataset keeps one pad row."""
    zero = torch.zeros(1, dtype=torch.float32, device=x.device)
    return torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device), zero, zero.clone()


# ------------------------------------------------------------ execution
def _stage(clock):
    return clock.stage if clock is not None else (lambda _: nullcontext())


def run_rowlevel(plan, table: Table, clock=None, device=None) -> DeviceView:
    """Evaluate a row-level plan on ``device`` (default the card);
    columns transfer (or hit the device cache) under the ``transfer``
    stage of ``clock`` (anything with a ``stage(name)`` context), the
    torch ops under ``sql``."""
    dev = resolve_device(device)
    n = len(table)
    sig = plan.kernel_sig
    stage = _stage(clock)
    with stage("transfer"):
        cols = tuple(table.device_column(c, dev) for c in kernel_columns(sig))
    with stage("sql"):
        mask, comp = _rowlevel(sig, n, cols, dev)
    aliases = [o[-2] for o in plan.outputs if o[0] in ("expr", "win")]
    return DeviceView(
        plan=plan, table=table, device=dev, n_rows=n, mask=mask,
        computed=dict(zip(aliases, comp)),
    )


def _run_aggregate(plan, table: Table, clock=None, device=None) -> Table:
    dev = resolve_device(device)
    n = len(table)
    sig = plan.kernel_sig
    stage = _stage(clock)
    types = dict(plan.col_types)
    sdicts: dict[str, np.ndarray] = {}

    def operand(c: str):
        if types.get(c) == "s":
            # strings never transfer: encode host-side to sorted-rank
            # int64 codes (null code = len(uniq), sorting last) and let
            # the segment machinery group over the codes
            codes, uniq = string_group_codes(table.column(c))
            sdicts[c] = uniq
            return torch.from_numpy(codes).to(dev)
        return table.device_column(c, dev)

    with stage("transfer"):
        cols = tuple(operand(c) for c in kernel_columns(sig))
    with stage("sql"):
        n_groups, outs = _aggregate(sig, n, cols, dev)
        host = _fetch([n_groups, *outs])  # the single host sync
    g = int(host[0])
    cols_out: dict[str, np.ndarray] = {}
    for o, arr in zip(plan.outputs, host[1:]):
        if arr.ndim == 0:
            arr = arr[None]
        vals = arr[:g]
        if o[0] == "key":
            src, ch = plan.group_keys[o[1]]
            if ch == "t":
                vals = vals.astype(np.int64).view("datetime64[ns]")
            elif ch == "s":
                # codes → values through the per-call dictionary; the
                # null code (one past the last rank) decodes to None
                uniq = sdicts[src]
                lut = np.empty(len(uniq) + 1, dtype=object)
                lut[: len(uniq)] = uniq
                lut[len(uniq)] = None
                vals = lut[vals.astype(np.int64)]
            cols_out[o[2]] = vals
        elif o[0] == "count_star":
            cols_out[o[1]] = vals.astype(np.int64)
        else:
            cols_out[o[3]] = (
                vals.astype(np.int64) if o[1] == "count" else vals
            )
    return Table.from_dict(cols_out)


def run_plan(plan, table: Table, clock=None, device=None) -> Table:
    """Fully-supported plan → host Table via the compiled executor."""
    if plan.kind == "rowlevel":
        return run_rowlevel(plan, table, clock, device).to_table()
    return _run_aggregate(plan, table, clock, device)


def compile_rowlevel(
    query: str, resolve_table, mode: str = "auto", clock=None, device=None
) -> DeviceView | None:
    """Parse + plan + run a row-level query entirely on the device, for
    consumers that keep going there (fused assembly).  ``None`` when the
    plan has fallback nodes, isn't row-level, or carries LIMIT
    (mask-only representations cannot honor it) — unless
    ``mode="compile"``, which raises with the per-node reasons."""
    from .sql import (
        REASON_DISABLED,
        SqlCompileUnsupported,
        _compile_enabled,
        record_dispatch,
    )
    from .sql_plan import plan_query

    if mode not in ("auto", "interpret", "compile"):
        raise ValueError(
            f"mode must be auto|interpret|compile, got {mode!r}"
        )
    if mode == "interpret" or (not _compile_enabled() and mode != "compile"):
        # mode="interpret" forces the caller's host fallback; the
        # operator's kill switch covers the fused path too
        reason = (
            ("query", "mode=interpret")
            if mode == "interpret"
            else REASON_DISABLED
        )
        record_dispatch(query, "interpreter", (reason,))
        return None
    dev = resolve_device(device)
    node = parse(query)
    plan = plan_query(node, resolve_table) if isinstance(node, _Query) else None
    reasons: list = []
    if plan is None:
        reasons = [("query", "not a single-table SELECT")]
    elif not plan.fully_supported:
        reasons = plan.fallback_reasons()
    elif plan.kind != "rowlevel":
        reasons = [("aggregate", "fused assembly needs a row-level query")]
    elif plan.limit is not None:
        reasons = [("limit", "fused assembly cannot honor LIMIT")]
    if reasons:
        if mode == "compile":
            raise SqlCompileUnsupported(query, reasons)
        record_dispatch(query, "interpreter", tuple(reasons))
        return None
    view = run_rowlevel(plan, plan.source, clock, dev)
    record_dispatch(query, "compiled", (), plan.fingerprint)
    return view
