"""Padded positions over all positions of the chunks sample() ran in the window, %."""


def read(facts):
    c = facts.get("chunks", ())
    total = sum(b * l for b, l, _, _ in c)
    return 100.0 * (total - sum(real for _, _, real, _ in c)) / total if total else None
