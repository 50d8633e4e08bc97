"""Horizontal inner-loop parallelization (paper §4.6).

Sequential inner loops written by the programmer cannot be parallelized
across work-items unless the compiler proves their trip count is the same
for every work-item.  When the uniformity analysis shows that the loop exit
condition *and* the predicates on the path to the loop entry are
work-item-invariant, implicit barriers are inserted around/inside the loop —
exactly the §4.5 b-loop barriers — which interchanges the work-item loop with
the inner loop: the inner loop becomes the outer, lock-step loop, and each
iteration's body is a parallel region executed for all work-items at once.

On the vector target this turns a per-lane masked loop into a single scalar
loop over a fully vectorized body (the paper's DCT case study, §6.4).
"""

from __future__ import annotations

from typing import Dict, Set

from .ir import CondBranch, Function, Value
from . import uniformity as ua


def horizontal_candidates(fn: Function) -> Set[str]:
    """Headers of barrier-free natural loops that are legal to interchange:
    uniform exit condition, uniform entry predicate, and all enclosing loops
    equally uniform (so the b-loop fixpoint never forces lockstep onto a
    divergent loop)."""
    info = ua.analyze(fn)
    loops = fn.natural_loops()

    def loop_uniform(header: str, body: Set[str]) -> bool:
        hdr = fn.blocks[header]
        term = hdr.terminator
        if not isinstance(term, CondBranch):
            return False  # not in canonical while form
        if isinstance(term.cond, Value) and not info.value_uniform(term.cond):
            return False
        if not info.block_uniform(header):
            return False
        return True

    uniform_headers: Set[str] = set()
    body_of: Dict[str, Set[str]] = {}
    for header, body in loops:
        body_of[header] = body
        if loop_uniform(header, body):
            uniform_headers.add(header)

    # a loop qualifies only if every enclosing loop is uniform as well
    out: Set[str] = set()
    for header in uniform_headers:
        enclosing = [h for h, b in body_of.items()
                     if h != header and header in b]
        if all(h in uniform_headers for h in enclosing):
            out.add(header)
    # the barrier-containing loops are already b-loops; only add barrier-free
    out = {h for h in out
           if not any(fn.blocks[b].has_barrier() for b in body_of[h])}
    return out
