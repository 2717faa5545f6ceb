"""Maximum-weight matching on a dense weight matrix (Edmonds' blossom
algorithm, primal-dual, O(n^3)), for Christofides' minimum-weight perfect
matching without networkx.

This follows the structure of networkx's `max_weight_matching` (after Joris
van Rantwijk's `mwmatching.py`, and Galil, "Efficient algorithms for finding
maximum matching in graphs", 1986) on a complete graph given as a matrix:
vertices are 0..n-1, non-trivial blossoms get the ids n..2n-1. A vertex's
scan over its neighbours, the least-slack bookkeeping and the dual updates
are numpy operations over whole rows; only the tight edges are walked one by
one. On a graph whose optimum is unique the result is the same matching as
networkx's, whatever order the edges are met in.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def max_weight_matching(weight: np.ndarray, maxcardinality: bool = False) -> np.ndarray:
    """`mate` [n] int64 (-1 where unmatched) of a maximum-weight matching of
    the complete graph with symmetric edge weights `weight` [n, n] (the
    diagonal is ignored); with `maxcardinality`, the maximum weight among
    the matchings of largest size."""
    w = np.asarray(weight, np.float64)
    n = w.shape[0]
    if n < 2:
        return -np.ones(n, np.int64)
    off = ~np.eye(n, dtype=bool)
    maxweight = max(0.0, float(w[off].max()))
    nb = 2 * n
    mate = -np.ones(n, np.int64)
    label = np.zeros(nb, np.int64)  # 0 none, 1 S, 2 T (5: S being scanned)
    le_v = -np.ones(nb, np.int64)  # labeledge (v, w) or -1
    le_w = -np.ones(nb, np.int64)
    inblossom = np.arange(n)
    parent = -np.ones(nb, np.int64)
    base = np.concatenate([np.arange(n), -np.ones(n, np.int64)])
    childs: List[Optional[List[int]]] = [None] * nb
    bedges: List[Optional[List[Tuple[int, int]]]] = [None] * nb
    mybest: List[Optional[List[Tuple[int, int]]]] = [None] * nb
    be_v = -np.ones(nb, np.int64)  # bestedge (v, w) or -1
    be_w = -np.ones(nb, np.int64)
    dual = np.full(n, maxweight)
    bdual = np.zeros(nb)
    allow = np.zeros((n, n), bool)
    free_ids = list(range(nb - 1, n - 1, -1))
    active: List[int] = []  # non-trivial blossoms
    queue: List[int] = []

    def slack(v: int, x: int) -> float:
        return dual[v] + dual[x] - 2.0 * w[v, x]

    def leaves(b: int) -> List[int]:
        if b < n:
            return [b]
        out, stack = [], [b]
        while stack:
            t = stack.pop()
            if t < n:
                out.append(t)
            else:
                stack.extend(childs[t])
        return out

    def assign_label(x: int, t: int, v: int) -> None:
        b = inblossom[x]
        label[x] = label[b] = t
        le_v[x] = le_v[b] = v
        le_w[x] = le_w[b] = x if v >= 0 else -1
        be_v[x] = be_v[b] = -1
        be_w[x] = be_w[b] = -1
        if t == 1:
            queue.extend(leaves(b))
        else:
            bs = base[b]
            assign_label(int(mate[bs]), 1, int(bs))

    def scan_blossom(v: int, x: int) -> int:
        path, found = [], -1
        while v != -1:
            b = inblossom[v]
            if label[b] & 4:
                found = int(base[b])
                break
            path.append(b)
            label[b] = 5
            if le_v[b] == -1:
                v = -1
            else:
                v = int(le_v[b])
                b = inblossom[v]
                v = int(le_v[b])
            if x != -1:
                v, x = x, v
        for b in path:
            label[b] = 1
        return found

    def add_blossom(bs: int, v: int, x: int) -> None:
        bb, bv, bw = inblossom[bs], inblossom[v], inblossom[x]
        b = free_ids.pop()
        active.append(b)
        base[b], parent[b], parent[bb] = bs, -1, b
        path, edgs = [], [(v, x)]
        while bv != bb:
            parent[bv] = b
            path.append(int(bv))
            edgs.append((int(le_v[bv]), int(le_w[bv])))
            v = int(le_v[bv])
            bv = inblossom[v]
        path.append(int(bb))
        path.reverse()
        edgs.reverse()
        while bw != bb:
            parent[bw] = b
            path.append(int(bw))
            edgs.append((int(le_w[bw]), int(le_v[bw])))
            x = int(le_v[bw])
            bw = inblossom[x]
        childs[b], bedges[b] = path, edgs
        label[b], le_v[b], le_w[b], bdual[b] = 1, le_v[bb], le_w[bb], 0.0
        for u in leaves(b):
            if label[inblossom[u]] == 2:
                queue.append(u)
            inblossom[u] = b
        # the least-slack edge from b to each other top-level S-blossom
        best_s = np.full(nb, np.inf)
        best_i = -np.ones(nb, np.int64)
        best_j = -np.ones(nb, np.int64)
        s_top = label[inblossom] == 1
        for sub in path:
            if sub >= n and mybest[sub] is not None:
                pairs = np.asarray(mybest[sub], np.int64).reshape(-1, 2)
                i, j = pairs[:, 0].copy(), pairs[:, 1].copy()
                swap = inblossom[j] == b
                i[swap], j[swap] = pairs[swap, 1], pairs[swap, 0]
                mybest[sub] = None
            else:
                lv = np.asarray(leaves(sub), np.int64)
                i = np.repeat(lv, n)
                j = np.tile(np.arange(n), lv.size)
            bj = inblossom[j]
            keep = (bj != b) & s_top[j] & (i != j)
            i, j, bj = i[keep], j[keep], bj[keep]
            s = dual[i] + dual[j] - 2.0 * w[i, j]
            order = np.lexsort((s, bj))
            firsts = order[np.unique(bj[order], return_index=True)[1]]
            better = s[firsts] < best_s[bj[firsts]]
            f = firsts[better]
            best_s[bj[f]], best_i[bj[f]], best_j[bj[f]] = s[f], i[f], j[f]
            be_v[sub] = be_w[sub] = -1
        targets = np.nonzero(best_i >= 0)[0]
        mybest[b] = [(int(best_i[t]), int(best_j[t])) for t in targets]
        be_v[b] = be_w[b] = -1
        if targets.size:
            t = targets[np.argmin(best_s[targets])]
            be_v[b], be_w[b] = best_i[t], best_j[t]

    def expand_blossom(b0: int, endstage: bool) -> None:
        def recurse(b: int, endstage: bool):
            for s in childs[b]:
                parent[s] = -1
                if s >= n:
                    if endstage and bdual[s] == 0:
                        yield s
                    else:
                        for u in leaves(s):
                            inblossom[u] = s
                else:
                    inblossom[s] = s
            if not endstage and label[b] == 2:
                entry = inblossom[le_w[b]]
                j = childs[b].index(entry)
                if j & 1:
                    j -= len(childs[b])
                    jstep = 1
                else:
                    jstep = -1
                v, x = int(le_v[b]), int(le_w[b])
                while j != 0:
                    if jstep == 1:
                        p, q = bedges[b][j]
                    else:
                        q, p = bedges[b][j - 1]
                    label[x] = 0
                    label[q] = 0
                    assign_label(x, 2, v)
                    allow[p, q] = allow[q, p] = True
                    j += jstep
                    if jstep == 1:
                        v, x = bedges[b][j]
                    else:
                        x, v = bedges[b][j - 1]
                    allow[v, x] = allow[x, v] = True
                    j += jstep
                bw = childs[b][j]
                label[x] = label[bw] = 2
                le_v[x] = le_v[bw] = v
                le_w[x] = le_w[bw] = x
                be_v[bw] = be_w[bw] = -1
                j += jstep
                while childs[b][j] != entry:
                    bv = childs[b][j]
                    if label[bv] == 1:
                        j += jstep
                        continue
                    lab = [u for u in leaves(bv) if label[u]]
                    if lab:
                        u = lab[0]
                        label[u] = 0
                        label[mate[base[bv]]] = 0
                        assign_label(u, 2, int(le_v[u]))
                    j += jstep
            label[b], le_v[b], le_w[b], be_v[b], be_w[b] = 0, -1, -1, -1, -1
            parent[b], base[b], bdual[b] = -1, -1, 0.0
            childs[b] = bedges[b] = mybest[b] = None
            active.remove(b)
            free_ids.append(b)

        stack = [recurse(b0, endstage)]
        while stack:
            for s in stack[-1]:
                stack.append(recurse(s, endstage))
                break
            else:
                stack.pop()

    def augment_blossom(b0: int, v0: int) -> None:
        def recurse(b: int, v: int):
            t = v
            while parent[t] != b:
                t = parent[t]
            if t >= n:
                yield (t, v)
            i = j = childs[b].index(t)
            if i & 1:
                j -= len(childs[b])
                jstep = 1
            else:
                jstep = -1
            while j != 0:
                j += jstep
                t = childs[b][j]
                if jstep == 1:
                    x, y = bedges[b][j]
                else:
                    y, x = bedges[b][j - 1]
                if t >= n:
                    yield (t, x)
                j += jstep
                t = childs[b][j]
                if t >= n:
                    yield (t, y)
                mate[x], mate[y] = y, x
            childs[b] = childs[b][i:] + childs[b][:i]
            bedges[b] = bedges[b][i:] + bedges[b][:i]
            base[b] = base[childs[b][0]]

        stack = [recurse(b0, v0)]
        while stack:
            for args in stack[-1]:
                stack.append(recurse(*args))
                break
            else:
                stack.pop()

    def augment_matching(v: int, x: int) -> None:
        for s, j in ((v, x), (x, v)):
            while True:
                bs = inblossom[s]
                if bs >= n:
                    augment_blossom(int(bs), s)
                mate[s] = j
                if le_v[bs] == -1:
                    break
                t = int(le_v[bs])
                bt = inblossom[t]
                s, j = int(le_v[bt]), int(le_w[bt])
                if bt >= n:
                    augment_blossom(int(bt), j)
                mate[j] = s

    def scan(v: int) -> bool:
        """Scan S-vertex v's edges; True when the matching was augmented."""
        bv = inblossom[v]
        others = np.nonzero((inblossom != bv) & off[v])[0]
        s = dual[v] + dual[others] - 2.0 * w[v, others]
        newly = others[s <= 0]
        allow[v, newly] = allow[newly, v] = True
        for x in others[allow[v, others]]:
            x = int(x)
            bv, bx = inblossom[v], inblossom[x]
            if bv == bx:
                continue
            if label[bx] == 0:
                assign_label(x, 2, v)
            elif label[bx] == 1:
                bs = scan_blossom(v, x)
                if bs != -1:
                    add_blossom(bs, v, x)
                else:
                    augment_matching(v, x)
                    return True
            elif label[x] == 0:
                label[x], le_v[x], le_w[x] = 2, v, x
        # least-slack bookkeeping over the edges that are not tight
        bv = inblossom[v]
        rest = ~allow[v, others] & (inblossom[others] != bv)
        cand, cs = others[rest], s[rest]
        to_s = label[inblossom[cand]] == 1
        if to_s.any():
            k = int(np.argmin(cs[to_s]))
            if be_v[bv] == -1 or cs[to_s][k] < slack(int(be_v[bv]), int(be_w[bv])):
                be_v[bv], be_w[bv] = v, cand[to_s][k]
        free = ~to_s & (label[cand] == 0)
        fx, fs = cand[free], cs[free]
        has = be_v[fx] != -1
        cur = np.where(has, dual[np.maximum(be_v[fx], 0)] + dual[fx] - 2.0 * w[np.maximum(be_v[fx], 0), fx], np.inf)
        upd = fx[fs < cur]
        be_v[upd], be_w[upd] = v, upd
        return False

    while True:
        label[:] = 0
        le_v[:] = le_w[:] = -1
        be_v[:] = be_w[:] = -1
        for b in active:
            mybest[b] = None
        allow[:] = False
        queue.clear()
        for v in range(n):
            if mate[v] == -1 and label[inblossom[v]] == 0:
                assign_label(v, 1, -1)
        augmented = False
        while True:
            while queue and not augmented:
                augmented = scan(queue.pop())
            if augmented:
                break
            deltatype, delta, dedge, dblossom = -1, None, None, -1
            if not maxcardinality:
                deltatype, delta = 1, float(dual.min())
            top_label = label[inblossom]
            fv = np.nonzero((top_label == 0) & (be_v[:n] != -1))[0]
            if fv.size:
                d2 = dual[be_v[fv]] + dual[be_w[fv]] - 2.0 * w[be_v[fv], be_w[fv]]
                k = int(np.argmin(d2))
                if deltatype == -1 or d2[k] < delta:
                    deltatype, delta, dedge = 2, float(d2[k]), (int(be_v[fv[k]]), int(be_w[fv[k]]))
            tops = np.concatenate([np.arange(n)[parent[:n] == -1],
                                   np.asarray([b for b in active if parent[b] == -1], np.int64)])
            sb = tops[(label[tops] == 1) & (be_v[tops] != -1)]
            if sb.size:
                d3 = (dual[be_v[sb]] + dual[be_w[sb]] - 2.0 * w[be_v[sb], be_w[sb]]) / 2.0
                k = int(np.argmin(d3))
                if deltatype == -1 or d3[k] < delta:
                    deltatype, delta, dedge = 3, float(d3[k]), (int(be_v[sb[k]]), int(be_w[sb[k]]))
            for b in active:
                if parent[b] == -1 and label[b] == 2 and (deltatype == -1 or bdual[b] < delta):
                    deltatype, delta, dblossom = 4, float(bdual[b]), b
            if deltatype == -1:
                deltatype, delta = 1, max(0.0, float(dual.min()))
            dual[top_label == 1] -= delta
            dual[top_label == 2] += delta
            for b in active:
                if parent[b] == -1:
                    if label[b] == 1:
                        bdual[b] += delta
                    elif label[b] == 2:
                        bdual[b] -= delta
            if deltatype == 1:
                break
            if deltatype in (2, 3):
                v, x = dedge
                allow[v, x] = allow[x, v] = True
                queue.append(v)
            else:
                expand_blossom(dblossom, False)
        if not augmented:
            break
        for b in list(active):
            if b in active and parent[b] == -1 and label[b] == 1 and bdual[b] == 0:
                expand_blossom(b, True)
    return mate


def min_weight_perfect_matching(dist: np.ndarray) -> List[Tuple[int, int]]:
    """Minimum-weight perfect matching of the complete graph on an even
    number of vertices with distances `dist` [n, n], as networkx's
    `min_weight_matching` finds it: a maximum-cardinality maximum-weight
    matching on the weights 1 + max(dist) - dist. Returns the pairs (u, v),
    u < v, in order of u."""
    d = np.asarray(dist, np.float64)
    n = d.shape[0]
    if n == 0:
        return []
    off = ~np.eye(n, dtype=bool)
    inv = (1.0 + float(d[off].max())) - d
    mate = max_weight_matching(np.where(off, inv, 0.0), maxcardinality=True)
    if (mate < 0).any():
        raise RuntimeError("the matching is not perfect")
    return [(u, int(mate[u])) for u in range(n) if u < mate[u]]
