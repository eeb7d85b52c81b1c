"""Shared sweep definitions (port of ``repro.uvm.sweeps``): the policy x
prefetch x oversubscription equivalence matrix.  The reference's
``run_batch_forced_devices`` reruns a sweep in a child process with forced
host XLA devices to exercise its lane-sharded path; the port runs on one
card, where lanes are not sharded, so it has no counterpart."""
from __future__ import annotations

EQUIV_CELLS = [
    (pol, pf, os_)
    for pol in ("lru", "belady", "hpe", "learned")
    for pf in ("demand", "tree")
    for os_ in (1.25, 1.5)
]  # 16 cells: the equivalence-suite matrix (`random` exempt by contract)
