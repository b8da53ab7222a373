"""Distinct (B, L) chunk shapes per job (each costs one capture of its graphs)."""


def read(facts):
    jobs = {}
    for b, l, _, job in facts["chunks"]:
        jobs.setdefault(job, set()).add((b, l))
    return sum(len(s) for s in jobs.values()) / len(jobs) if jobs else None
