"""captures_per_round: the programs the process captured during the window
(`utils/aot.py::CAPTURES`), over the window's rounds: a restart round whose
lane count is new captures its programs there, as a sweep pays for them
(None where the program has no such counter)."""


def read(ctx):
    captures, rounds = ctx.counters.get("captures"), ctx.counters.get("rounds")
    if captures is None or not rounds:
        return None
    return captures / rounds
